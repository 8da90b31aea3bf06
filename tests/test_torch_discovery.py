"""GPU resource discovery (``spark_rapids_tpu_torch.discovery``) against the
JAX package's ``tests/test_discovery.py``: Spark's discovery-script
protocol (on the CPU through ``--device cpu``; without it the script needs
a GPU and raises here) and exclusive per-device claims that never collide,
in an isolated lock directory."""
import json
import os
import subprocess
import sys

import pytest
import torch

from spark_rapids_tpu import discovery as jax_discovery
from spark_rapids_tpu_torch import discovery

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script(*args):
    return subprocess.run(
        [sys.executable, "-m", "spark_rapids_tpu_torch.discovery", *args],
        capture_output=True, text=True, cwd=ROOT,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": ROOT})


def test_discovery_script_protocol_on_the_cpu():
    out = _script("--device", "cpu")
    assert out.returncode == 0, out.stderr
    doc = json.loads(out.stdout.strip().splitlines()[-1])
    assert doc == {"name": "gpu", "addresses": ["0"]}


def test_discovery_script_needs_a_gpu_by_default():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default lists it")
    out = _script()
    assert out.returncode != 0
    assert out.stdout == ""
    assert "no CUDA device is visible" in out.stderr


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_exclusive_claims_do_not_collide(pkg, tmp_path):
    mod = jax_discovery if pkg == "jax" else discovery
    d = str(tmp_path)
    addrs = ["91", "92"]
    a = mod.acquire_exclusive(addrs, lock_dir=d)
    b = mod.acquire_exclusive(addrs, lock_dir=d)
    c = mod.acquire_exclusive(addrs, lock_dir=d)
    try:
        assert a is not None and b is not None
        assert {a.address, b.address} == set(addrs)
        assert c is None
    finally:
        for claim in (a, b):
            if claim:
                claim.release()
    again = mod.acquire_exclusive(addrs, lock_dir=d)
    assert again is not None
    again.release()
    prefix = "tpu" if pkg == "jax" else "gpu"
    assert sorted(os.listdir(d)) == [f"{prefix}-91.lock", f"{prefix}-92.lock"]


def test_claim_records_the_pid_only_once_held(tmp_path):
    d = str(tmp_path)
    held = discovery.acquire_exclusive(["7"], lock_dir=d)
    try:
        path = os.path.join(d, "gpu-7.lock")
        assert open(path).read() == str(os.getpid())
        # a second claim on the held device fails and leaves the record
        assert discovery.acquire_exclusive(["7"], lock_dir=d) is None
        assert open(path).read() == str(os.getpid())
    finally:
        held.release()


def test_unopenable_lock_counts_as_claimed(tmp_path):
    d = tmp_path / "locks"
    d.mkdir()
    (d / "gpu-5.lock").mkdir()          # open() of a directory fails
    claim = discovery.acquire_exclusive(["5", "6"], lock_dir=str(d))
    try:
        assert claim is not None and claim.address == "6"
    finally:
        claim.release()


def test_visible_devices_kinds():
    assert discovery.visible_devices("cpu") == ["0"]
    with pytest.raises(ValueError):
        discovery.visible_devices("tpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            discovery.visible_devices()
