"""The legacy trainer's jobs in the port's CLI (`python -m
paddle_tpu_torch train|test|time|checkgrad`), on the CPU.

The twins of tests/test_cli.py's job tests on the same fixture config
(tests/fixtures/cli/tiny_config.py and its provider), run in process
through `paddle_tpu_torch.cli.main(...)` with `--device cpu`: the same
log lines and JSON records, pass snapshots in SAVE_DIR/pass-%05d, the
loss falling, checkgrad's finite differences. Across packages: a
pass-00000 the JAX package's `train --use_tpu=0` saved tests in the
port to the JAX `test` job's cost within 1e-5, and the port's snapshot
tests in the JAX package to the port's. Without `--device` the job runs
on the card, and with none visible it raises.
"""

import json
import os

import numpy as np
import pytest
import torch

import paddle_tpu as jpt
from paddle_tpu import cli as jcli
from paddle_tpu_torch import cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(REPO, "tests", "fixtures", "cli", "tiny_config.py")


def _port(capsys, *args):
    rc = cli.main([*args, f"--config={CFG}", "--device=cpu"])
    return rc, capsys.readouterr().out


def _reference(capsys, *args):
    jpt.framework.reset_default_programs()
    rc = jcli.main([*args, f"--config={CFG}", "--use_tpu=0"])
    return rc, capsys.readouterr().out


def _last_json(stdout):
    for line in reversed(stdout.strip().splitlines()):
        if line.startswith("{"):
            return json.loads(line)
    raise AssertionError(f"no JSON line in output:\n{stdout}")


def test_train_saves_passes_and_logs(tmp_path, capsys):
    rc, out = _port(capsys, "train", "--num_passes=2", "--log_period=4",
                    f"--save_dir={tmp_path}",
                    "--config_args=batch_size=16,hidden=8")
    assert rc == 0
    assert "Pass 0, Batch 4, Cost " in out
    assert "Pass 1 done; test cost " in out
    assert (tmp_path / "pass-00000").is_dir()
    assert (tmp_path / "pass-00001").is_dir()
    costs = [float(ln.split("Cost ")[1].split(",")[0])
             for ln in out.splitlines() if "Cost" in ln]
    assert np.isfinite(costs).all() and costs[-1] < costs[0], costs


def test_test_job_loads_saved_model(tmp_path, capsys):
    rc, _ = _port(capsys, "train", "--num_passes=3",
                  f"--save_dir={tmp_path}", "--log_period=0")
    assert rc == 0
    rc, out = _port(capsys, "test",
                    f"--init_model_path={tmp_path}/pass-00002")
    assert rc == 0
    rec = _last_json(out)
    assert rec["job"] == "test"
    # 3 passes on linearly-separable data: solidly below chance ln(2)
    assert rec["cost"] < 0.5, rec


def test_time_job(capsys):
    rc, out = _port(capsys, "time", "--num_batches=4")
    assert rc == 0
    rec = _last_json(out)
    assert rec["job"] == "time" and rec["batches"] == 4
    assert rec["batch_size"] == 16
    assert rec["ms_per_batch"] > 0 and rec["samples_per_sec"] > 0


def test_checkgrad_job(capsys):
    rc, out = _port(capsys, "checkgrad",
                    "--config_args=batch_size=8,hidden=4")
    assert rc == 0, out
    assert "original cost = " in out
    diff = float(out.split("max relative diff = ")[1].split()[0])
    assert diff < 5e-2


def test_time_job_dumps_metrics_snapshot(tmp_path, capsys):
    snap_path = str(tmp_path / "telemetry.json")
    rc, _ = _port(capsys, "time", "--num_batches=2",
                  f"--metrics_path={snap_path}")
    assert rc == 0
    snap = json.load(open(snap_path))
    assert "counters" in snap and "histograms" in snap


def test_reference_snapshot_tests_in_the_port(tmp_path, capsys):
    """pass-00000 saved by the JAX package's train job: the port's test
    job on it gives the JAX test job's cost (1e-5); the port's own
    snapshot gives the same cost in the JAX package's test job."""
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    rc, _ = _reference(capsys, "train", "--num_passes=1", "--log_period=0",
                       f"--save_dir={jdir}")
    assert rc == 0
    rc, jout = _reference(capsys, "test",
                          f"--init_model_path={jdir}/pass-00000")
    assert rc == 0
    rc, pout = _port(capsys, "test", f"--init_model_path={jdir}/pass-00000")
    assert rc == 0
    jcost, pcost = _last_json(jout)["cost"], _last_json(pout)["cost"]
    np.testing.assert_allclose(pcost, jcost, rtol=1e-5)

    rc, _ = _port(capsys, "train", "--num_passes=1", "--log_period=0",
                  f"--save_dir={pdir}")
    assert rc == 0
    rc, pout = _port(capsys, "test", f"--init_model_path={pdir}/pass-00000")
    rc2, jout = _reference(capsys, "test",
                           f"--init_model_path={pdir}/pass-00000")
    assert rc == rc2 == 0
    np.testing.assert_allclose(_last_json(jout)["cost"],
                               _last_json(pout)["cost"], rtol=1e-5)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is visible")
@pytest.mark.parametrize("job", ["train", "test", "time", "checkgrad"])
def test_no_card_and_no_device_raises(job):
    with pytest.raises(RuntimeError, match="none is visible"):
        cli.main([job, f"--config={CFG}"])
