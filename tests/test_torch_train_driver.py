"""The port's LM training driver (``python -m repro_torch.launch.train``) on
the CPU: the reference test's run (``test_system.py::
test_train_driver_with_failure_and_gwlz_ckpt``), bit-equal replay after a
restart, and checkpoints that cross between the two drivers.

Checkpoints hold the loop state ``(params, opt_state, rng)`` under the
reference's keys, so each driver restores the other's, parameters and
moments bit for bit (bfloat16 leaves compared as their bits).  The step
counter is a Python int in the port (int64 on disk) and int32 in the
reference; the rng key is uint32[2] in both.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as RManager
from repro.configs import build_model as ref_build_model
from repro.optim import AdamWConfig as RAdamWConfig
from repro.optim import adamw as RA
from repro_torch import tree
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import build_model
from repro_torch.launch import train as driver
from repro_torch.optim import AdamWConfig
from repro_torch.optim import adamw as PA

ARGS = ["--arch", "granite-3-8b", "--reduced", "--batch", "4", "--seq", "16"]


def _port_state(moment_dtype="fp32"):
    model, _ = build_model("granite-3-8b", reduced=True, device="cpu")
    params = model.init(torch.Generator().manual_seed(9))
    cfg = AdamWConfig(weight_decay=0.1, moment_dtype=moment_dtype)
    return (params, PA.init(params, cfg), driver.prng_key(1))


def _bits(x) -> np.ndarray:
    """A leaf's bits as an integer array (bfloat16 and floats compared
    exactly, whatever the package)."""
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        return np.asarray(x.numpy())
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _same_bits(a, b) -> bool:
    a, b = _bits(a), _bits(b)
    if a.dtype.kind == "f":  # compare floats as their bits
        a, b = a.view(f"i{a.itemsize}"), b.view(f"i{b.itemsize}")
    return a.shape == b.shape and np.array_equal(a.astype(np.int64), b.astype(np.int64))


def test_reference_arguments_survive_the_failure_and_learn(tmp_path):
    losses = driver.main(ARGS + ["--steps", "40", "--lr", "3e-3", "--ckpt-every", "8",
                                 "--ckpt-dir", str(tmp_path), "--inject-failure-at", "12",
                                 "--gwlz-ckpt-eb", "1e-4", "--device", "cpu"])
    assert len(losses) >= 40 and all(np.isfinite(losses))
    # the tiny random-token task still has learnable unigram structure
    assert min(losses[-8:]) < losses[0]


@pytest.mark.parametrize("moment_dtype", ["fp32", "bf16", "int8"])
def test_restarted_run_is_bit_equal_to_a_clean_one(tmp_path, moment_dtype):
    """Eight steps, a checkpoint every four, a failure at step 6: the
    replayed run ends on the clean run's bits, the int8 moments' stochastic
    rounding included (its draws come from the checkpointed key).  (Eight
    steps: int8 moments blow up within a dozen, in both packages; see
    ``test_torch_lm.py``.)"""
    runs = {}
    for name, fail in (("clean", []), ("failed", ["--inject-failure-at", "6"])):
        d = tmp_path / name
        losses = driver.main(ARGS + ["--steps", "8", "--ckpt-every", "4", "--ckpt-dir", str(d),
                                     "--moment-dtype", moment_dtype, "--device", "cpu"] + fail)
        runs[name] = (losses, CheckpointManager(d, device="cpu").restore(
            _port_state(moment_dtype), 8))
    (clean_losses, clean), (failed_losses, failed) = runs["clean"], runs["failed"]
    assert len(failed_losses) == len(clean_losses) + 2  # steps 4 and 5 replayed
    assert np.isfinite(clean_losses).all() and failed_losses[-4:] == clean_losses[-4:]
    for (path, a), (_, b) in zip(tree.leaves(clean), tree.leaves(failed)):
        assert _same_bits(a, b), path


def _ref_target(moment_dtype="fp32"):
    model, _ = ref_build_model("granite-3-8b", reduced=True)
    params = model.init(jax.random.PRNGKey(4))
    opt = RA.init(params, RAdamWConfig(weight_decay=0.1, moment_dtype=moment_dtype))
    return (params, opt, jax.random.PRNGKey(5))


def test_checkpoints_cross_between_the_drivers(tmp_path):
    from repro.launch import train as ref_driver

    common = ARGS + ["--steps", "8", "--ckpt-every", "8"]
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    ref_driver.main(common + ["--ckpt-dir", str(ref_dir)])
    driver.main(common + ["--ckpt-dir", str(port_dir), "--device", "cpu"])
    for d in (ref_dir, port_dir):  # both wrote step 8 under the same keys
        assert sorted(os.listdir(d)) == ["step_00000008"]
    with np.load(ref_dir / "step_00000008" / "arrays.npz") as a, \
            np.load(port_dir / "step_00000008" / "arrays.npz") as b:
        assert sorted(a.files) == sorted(b.files)

    # the reference's checkpoint into the port's tree ...
    mine = CheckpointManager(ref_dir, device="cpu").restore(_port_state())
    theirs = RManager(str(ref_dir)).restore(_ref_target())
    for (path, a), b in zip(tree.leaves(mine), jax.tree.leaves(theirs)):
        assert _same_bits(a, b), path
    assert int(mine[1]["step"]) == 8 and mine[2].dtype == torch.uint32
    # ... and the port's into the reference's
    theirs = RManager(str(port_dir)).restore(_ref_target())
    mine = CheckpointManager(port_dir, device="cpu").restore(_port_state())
    for (path, a), b in zip(tree.leaves(mine), jax.tree.leaves(theirs)):
        assert _same_bits(a, b), path
    assert int(theirs[1]["step"]) == 8 and theirs[2].dtype == jnp.uint32
    # the port's driver resumes the reference's run from its checkpoint
    resumed = driver.main(ARGS + ["--steps", "12", "--ckpt-every", "8",
                                  "--ckpt-dir", str(ref_dir), "--device", "cpu"])
    assert len(resumed) == 4 and all(np.isfinite(resumed))


def test_cuda_default_without_a_card_is_a_usage_error(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(SystemExit) as e:
        driver.main(ARGS + ["--steps", "1", "--ckpt-dir", str(tmp_path)])
    assert e.value.code == 2
