"""The port's dry-run (``python -m repro_torch.launch.dryrun``), as
``tests/test_dryrun.py`` holds the reference's: one (arch x shape) on the
production mesh writes its record, with the per-unit extrapolation
checked exactly against the full-depth trace; the multi-pod mesh and
olmoe's expert-parallel step too;
whisper's 500k decode is skipped with the reference's reason; and
``launch/report.py`` renders the records. The dry-run traces on ``meta``
tensors, so it runs in this process; the 40-combination sweep runs in a
subprocess and is slow."""
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import accounting as acct  # noqa: E402
from repro_torch.launch import dryrun, report  # noqa: E402

HERE = os.path.dirname(__file__)
SRC = os.path.join(HERE, "..", "src")


def _dryrun(out, *args):
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--out", str(out), *args])
    return e.value.code


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    codes = [_dryrun(out, "--arch", "smollm-135m", "--shape", "decode_32k"),
             _dryrun(out, "--arch", "smollm-135m", "--shape", "train_4k",
                     "--multipod"),
             _dryrun(out, "--arch", "olmoe-1b-7b", "--shape", "train_4k")]
    return out, codes


def test_dryrun_single_pod_decode(records):
    out, codes = records
    assert codes[0] == 0
    rec = json.load(open(out / "smollm-135m_decode_32k_16x16_xla.json"))
    assert rec["status"] == "ok"
    roof = rec["roofline"]
    assert roof["dominant"] in ("compute", "memory", "collective")
    assert roof["flops_per_device"] > 0
    assert rec["cost"]["units"] == 30
    assert rec["cost"]["extrapolation"] == "exact"
    assert rec["hardware"] == acct.HARDWARE
    assert "fits_16gb_hbm" not in rec and rec["fits_hbm"] is True
    # a 30-layer decode reads its whole cache: (30, 8, 32768, 3, 64) bf16
    # twice is this rank's block of the 128-row batch
    assert rec["memory"]["peak_bytes_per_device"] >= 2 * 30 * 8 * 32768 \
        * 3 * 64 * 2
    assert rec["kernel_launches"] == {}        # the dense cache is plain


def test_dryrun_multipod_train(records):
    out, codes = records
    assert codes[1] == 0
    rec = json.load(open(out / "smollm-135m_train_4k_2x16x16_xla.json"))
    assert rec["status"] == "ok"
    assert rec["mesh"] == "2x16x16"
    assert rec["topology"] == "cross_pod(2) > intra_pod(16)"
    # remat="full": each layer's forward kernel runs twice
    assert rec["kernel_launches"] == {"flash_attention": 60,
                                      "flash_attention_bwd": 60}
    assert rec["collective_bytes"]["all-reduce"] > 0


def test_dryrun_expert_parallel_train(records):
    out, codes = records
    assert codes[2] == 0
    rec = json.load(open(out / "olmoe-1b-7b_train_4k_16x16_xla.json"))
    # FSDP + expert parallelism under remat="full": 6 exchanges a layer
    # over model (the forward, its recompute and the backward, each both
    # ways), the shards gathered over data once a layer and once for
    # the rest of the tree
    by = rec["collectives_by_axis"]
    assert by["all-to-all@model"]["count"] == 6 * 16
    assert by["all-gather@data"]["count"] == by["reduce-scatter@data"][
        "count"] == 16 + 1
    assert rec["cost"]["units"] == 16 and rec["roofline"]["model_flops"] > 0


def test_dryrun_whisper_long_context_skip(tmp_path, capsys):
    assert _dryrun(tmp_path, "--arch", "whisper-large-v3", "--shape",
                   "long_500k") == 0
    assert "skip" in capsys.readouterr().out


def test_report_renders_the_records(records, tmp_path):
    out, _ = records
    _dryrun(out, "--arch", "whisper-large-v3", "--shape", "long_500k")
    recs = report.load(str(out))
    assert len(recs) == 4
    single = report.dryrun_table(recs)
    assert "fits 80GB" in single and "| smollm-135m | decode_32k | ok" \
        in single and "| whisper-large-v3 | long_500k | SKIP" in single
    assert "**memory**" in report.roofline_table(recs) or \
        "**compute**" in report.roofline_table(recs)
    assert "| smollm-135m | train_4k | ok" in report.dryrun_table(
        recs, mesh="2x16x16")


@pytest.mark.slow
def test_dryrun_all_combinations(tmp_path):
    env = dict(os.environ, PYTHONPATH=SRC)
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                        "--all", "--out", str(tmp_path)], env=env,
                       capture_output=True, text=True, timeout=3000)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.count("[ok  ]") == 39 and r.stdout.count("[skip]") == 1
