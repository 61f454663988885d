"""Hand-written Hopper kernels, one directory each, in the reference's
three-file split:

  * ``ref.py`` — the plain PyTorch version: what the CPU runs, and what the
    kernel is held against on the card;
  * the kernel: a CUDA C++ source for sm_90a plus its ctypes loader
    (``<name>.cu`` + ``<name>.py``), built at first use into ``build/``;
  * ``ops.py`` — dispatch by tensor device: a CUDA tensor goes to the
    kernel (or raises), a CPU tensor to the plain version.
"""
