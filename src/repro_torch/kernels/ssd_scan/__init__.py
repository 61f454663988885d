"""The Mamba-2 SSD chunk scan: ``ref.py`` (plain PyTorch), ``ssd_scan.cu``
+ ``ssd_scan.py`` (the Hopper forward kernel and its loader), ``ops.py``
(dispatch by device and the gradient; ``ops.ssd_scan`` is the entry
point)."""
