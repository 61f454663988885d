"""repro_torch — the PyTorch / CUDA port of the ``repro`` package for
NVIDIA Hopper (H100, sm_90a).

The package mirrors ``repro`` module for module (``repro_torch/models/
attention.py`` ports ``repro/models/attention.py`` and so on), imports
``torch`` and never ``jax``, and imports nothing from ``repro``.  Every TPU
kernel on a ported path becomes a kernel written by hand for Hopper under
``repro_torch/kernels/<name>/``, beside its plain PyTorch version
(``ref.py``) and an ``ops.py`` that sends a CUDA tensor to the kernel and a
CPU tensor to the plain version.

Entry points run on the card unless the caller names another device
(``device="cpu"``, as the tests do); where CUDA is absent they raise.

Ported so far: serving of the dense family (``serve.ServeEngine``,
``python -m repro_torch.launch.serve``) through the dense and paged
flash-decode kernels; on-policy Sebulba IMPALA over host environments
(``core.Sebulba``, ``python -m repro_torch.launch.sebulba_impala``) through
the V-trace kernel.
"""
