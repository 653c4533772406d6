"""PyTorch + CUDA port of the ``repro`` package, for one NVIDIA H100.

The JAX package ``repro`` stays the reference; this package imports
neither it nor JAX. Module names follow the reference so each
counterpart is easy to find:

  * ``configs``  — the model configs (copies);
  * ``kernels``  — plain PyTorch oracles (``ref``), the hand-written CUDA
                   kernels (``attention``, ``ssd_scan``, ``segment_reduce``;
                   sources in ``csrc/``) and the ``ops`` dispatch;
  * ``models``   — layers, the dense, SSM and hybrid models, ``build_model``;
  * ``core``     — the collective algorithms on a ``torch.distributed``
                   group (``collectives``, with the rank transport and
                   the mesh of ranks ``collectives/group.py``, and the
                   N-level and pipelined compositions), the cost models
                   (``analytical``), the tuning core (``tuning``) and the
                   topology model and artifacts (``topology``);
  * ``comms``    — the tuned ``Communicator`` and its requests, plans,
                   buckets and probe;
  * ``obs``      — trace spans and counters;
  * ``pytree``   — trees of tensors flattened as ``jax.tree`` flattens;
  * ``bridge``   — the JAX package's numpy params -> the port's modules;
  * ``serve``    — paged KV, the continuous-batching scheduler, the engine;
  * ``launch``   — ``python -m repro_torch.launch.serve``, ``.train``,
                   ``.measure_collectives``, and the compile-free
                   accounting ``.dryrun`` (``accounting``, ``report``);
  * ``count``    — the hook through which the kernels and the rank
                   transport report their work to the accounting.
"""
