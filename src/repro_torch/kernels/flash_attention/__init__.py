"""GQA flash attention: ``ref.py`` (plain PyTorch), ``flash_attention.cu``
+ ``flash_attention.py`` (the Hopper forward kernel and its loader),
``ops.py`` (dispatch by device; ``ops.flash_attention`` is the entry
point)."""
