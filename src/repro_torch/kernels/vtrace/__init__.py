"""V-trace: ``ref.py`` (plain PyTorch), ``vtrace.cu`` + ``vtrace.py`` (the
Hopper kernel and its loader), ``ops.py`` (dispatch by device;
``ops.vtrace`` is the entry point)."""
