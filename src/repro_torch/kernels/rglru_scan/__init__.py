"""The Griffin RG-LRU scan: ``ref.py`` (plain PyTorch), ``rglru_scan.cu`` +
``rglru_scan.py`` (the Hopper forward kernel and its loader), ``ops.py``
(dispatch by device and the gradient; ``ops.rglru_scan`` is the entry
point)."""
