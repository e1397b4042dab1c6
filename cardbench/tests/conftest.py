"""What the harness tests take, cell by cell, for the cells added after
them: the sizes at which the fp8 control, put in the program's place,
reads above the cell's limit on the CPU (``SHALLOW`` of
``test_cardbench_harness.py``), and the readers of the program's spans
and counters a traced run on the CPU reports (``PROGRAM_READERS`` of
``test_cardbench_spans.py``).  Each test module's table gains these rows
while its tests run."""
import pytest

CELL = "deepseek-v2-236b-ep8.serve-conv"

# DeepSeek-V2 at 6 layers (the dense one and 5 MoE layers) with the
# published MLA and expert widths but a CPU's d_model, heads and
# vocabulary: there the fp8 control reads 1.13 on seed 13 (0.51-1.13 on
# seeds 11-13), above the cell's limit 0.7, as it does at the cell's own
# size on the card (1.16-1.49, PERF.md)
SHALLOW = {CELL: ({"n_layers": 6, "d_model": 256, "n_heads": 8,
                   "d_ff": 512, "vocab": 2048}, 13,
                  {"clients": 8, "check_requests": 8, "check_batch": 8})}

PROGRAM_READERS = {CELL: {"moe_host_ms.decode", "mla_host_ms.decode",
                          "mla_cache_mb_per_step.decode"}}


@pytest.fixture(autouse=True)
def rows_of_later_cells(request, monkeypatch):
    for table in (SHALLOW, PROGRAM_READERS):
        name = "SHALLOW" if table is SHALLOW else "PROGRAM_READERS"
        rows = getattr(request.module, name, None)
        if rows is not None:
            for cell, row in table.items():
                monkeypatch.setitem(rows, cell, row)
