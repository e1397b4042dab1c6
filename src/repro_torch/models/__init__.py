"""The LM model stack: config schema, dense transformer layers, assembly."""
