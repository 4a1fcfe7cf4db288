"""repro_torch — the PyTorch/CUDA port of the space-filling-curve system.

``core`` holds the curve codecs and schedule generation (paper §3-§6),
``kernels`` the curve-scheduled applications of §7 on hand-written
Hopper kernels.  The JAX package ``repro`` is the reference the port is
held against; this package never imports it.
"""
