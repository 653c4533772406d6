"""PyTorch + CUDA port of the ``repro`` package, for one NVIDIA H100.

The JAX package ``repro`` stays the reference; this package imports
neither it nor JAX. Module names follow the reference so each
counterpart is easy to find:

  * ``configs``  — the model configs (a copy, dense family so far);
  * ``kernels``  — plain PyTorch oracles (``ref``), the hand-written CUDA
                   flash-attention kernel (``attention``, ``csrc/``) and
                   the ``ops.attention`` dispatch;
  * ``models``   — layers, the dense transformer, ``build_model``;
  * ``bridge``   — the JAX package's numpy params -> the port's modules;
  * ``serve``    — paged KV, the continuous-batching scheduler, the engine;
  * ``launch``   — ``python -m repro_torch.launch.serve``.
"""
