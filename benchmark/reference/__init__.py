"""The benchmark's plain reference: a frozen copy of the port's plain
PyTorch versions (scene compile, group trees, the cond tree walk, shading,
the Sobol and hash samplers, the integrator) taken from the repository at
commit 07b96da, with every kernel path and environment override removed,
and with an image decoder of its own (``io/decode.py``) in place of the
program's native one.

It imports nothing of the program, so later changes to the program do not
move it: it compiles the benchmark's scene files itself, renders the
pixels that a run checks, and counts the work that prices the render
kernel's roofline bound (``utils/workcount.py``)."""
