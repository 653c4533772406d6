"""FSDP with the model axis on the card, alone: ``chip_smoke.py``'s
[8m] ``"xla"`` run (olmoe-1b-7b at full width, 1 layer, 2 x 2), kept as
[8mf]'s oracle, then ``chip_smoke.phase_training_fsdp_model`` ([8ft]
whisper-large-v3 under FSDP + tensor parallelism, 2 + 2 layers at fp32
held to the same run without FSDP and 32 + 32 layers at 2 x 256; [8mf]
olmoe under FSDP + expert parallelism held to [8m] ``"xla"``). Prints
the phase's lines and each run's step breakdown (~4 min with set-up):

    python3 tools/fsdp_model_probe.py
"""
import os
import sys
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

if __name__ == "__main__":
    import torch

    import chip_smoke as cs
    if not torch.cuda.is_available():
        sys.exit("fsdp_model_probe: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    cs.phase_device()
    xla = cs.train_run("8m", "xla",
                       [*cs.MOE_TRAIN_ARGS, "--collective", "xla"],
                       config=cs.MOE_TRAIN_CONFIG)
    cs.STEP0_ORACLE["olmoe-1b-7b"] = {
        "grads0": xla.pop("grads0"), "loss": xla["losses"][0],
        "init_params": xla.pop("init_params"), "losses": xla["losses"],
        "params": xla.pop("params")}
    t1 = time.perf_counter()
    summary, paths = cs.phase_training_fsdp_model()
    print(f"launches by path: {paths}", flush=True)
    print(f"fsdp_model_probe: [8m] xla {t1 - t0:.1f}s, phase "
          f"{time.perf_counter() - t1:.1f}s", flush=True)
