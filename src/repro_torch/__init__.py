"""PyTorch/CUDA port of the N-Grammys speculative decoder (``repro``).

The JAX package ``repro`` is the reference; this package mirrors its module
layout (``repro_torch/models/attention.py`` <-> ``repro/models/attention.py``
and so on) and its public signatures.  The two TPU kernels of the main path
are CUDA kernels written for Hopper (``kernels/csrc``); every other tensor op
is plain PyTorch.

Entry points (``ServingEngine``, ``generate``, ``init_params``) take
``device=`` and default to ``"cuda"``: without a card they raise unless the
caller passes ``device="cpu"``, which runs the kernels' plain versions.
"""
