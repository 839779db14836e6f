"""The benchmark's harness: the window, the comparison, the trace readers,
the yardstick (see ../README.md)."""
