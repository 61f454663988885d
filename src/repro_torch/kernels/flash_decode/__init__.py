"""Flash-decode: ``ref.py`` (plain PyTorch), ``flash_decode.cu`` +
``flash_decode.py`` (the Hopper kernels and their loader), ``ops.py``
(dispatch by device; ``ops.flash_decode`` is the entry point)."""
