"""repro_torch — the PyTorch/CUDA port of Daisy, beside the JAX package.

The port mirrors ``repro``'s layout (``core``, ``kernels``, ``obs``,
``data``, ``dist``, ``service``, ``launch``, ``models``, ``serve``) and is held
against it: the same numpy inputs give the same answers, overlays,
checked bits, step reports and scope versions.  It imports torch and
numpy only.  Its entry points (``make_relation``, ``Daisy``, the
query-service launcher ``launch/serve.py``) run on ``"cuda"`` unless the
caller asks for ``"cpu"``; the DC pair scan runs as a hand-written CUDA
kernel (``csrc/dc_pairs.cu``) on the card and as its plain PyTorch
version on the CPU.
"""
