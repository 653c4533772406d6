"""The port's counterparts of the reference's ``examples/*.py``, each run
as ``python -m repro_torch.examples.<name>`` (``--device cpu`` on a
machine without a GPU, where the kernels take their plain versions):

- `train_e2e`: data pipeline -> training step -> checkpoint (in the
  reference's layout) -> restore -> resume;
- `serve_decode`: greedy decode through the dense KV cache, full and
  sliding-window;
- `quickstart`: the reduced smollm-135m trained on a data x model mesh
  of ranks under the ``xla``, ``ring`` and ``rabenseifner`` gradient
  syncs (`launch.train`);
- `autotune_collectives`: the tuning pipeline over the simulator, its
  four artifacts, and the Communicator's ``explain``;
- `measure_real_collectives`: the port's collectives measured in a
  group of ranks and tuned from those measurements
  (`launch.measure_collectives`).
"""
