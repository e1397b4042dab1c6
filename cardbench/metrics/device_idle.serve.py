"""The device's idle share of the traced window, in percent: 1 less the
union of every device operation's interval over the window's length
(``trace.idle_percent``)."""
from cardbench.trace import idle_percent


def read(ctx):
    return idle_percent(ctx["trace"])
