"""The port's version shims (``spark_rapids_tpu_torch/shims``) against the
JAX package's loader contract (``tests/test_tooling.py``): a provider is
picked by the runtime's version, ``get()`` raises when none matches, and
the toolchain identity is part of every kernel library's key, as the JAX
package's provider is part of every mesh program key
(``tests/test_program_key_regressions.py``)."""
import os
import stat

import pytest
import torch

from spark_rapids_tpu import shims as jax_shims
from spark_rapids_tpu_torch import cuda_build, shims


@pytest.fixture
def fresh_shims():
    """``get()`` and the ``nvcc`` release are cached per process: each
    test that swaps what they read starts and ends with empty caches."""
    shims.get.cache_clear()
    shims.nvcc_release.cache_clear()
    yield
    shims.get.cache_clear()
    shims.nvcc_release.cache_clear()


def test_loader_picks_the_provider_for_this_torch():
    s = shims.get()
    assert isinstance(s, shims.TorchShims)
    assert type(s).version_match(torch.__version__)
    assert shims.get() is s


@pytest.mark.parametrize("version,matches", [
    ("2.13.0+cpu", True), ("2.4.1", True), ("2.0.0a0+git1234", True),
    ("1.13.1", False), ("3.0.0", False), ("garbage", False)])
def test_provider_selection_logic(version, matches):
    assert shims.Torch2Shims.version_match(version) is matches


def test_selection_mirrors_the_reference_loader():
    """The same loader shape in both packages: a provider list in match
    order whose first ``version_match`` wins."""
    assert [c.__name__ for c in shims.PROVIDERS] == ["Torch2Shims"]
    assert all(issubclass(c, shims.TorchShims) for c in shims.PROVIDERS)
    assert all(issubclass(c, jax_shims.JaxShims)
               for c in jax_shims.PROVIDERS)


def test_get_raises_when_no_provider_matches(fresh_shims, monkeypatch):
    monkeypatch.setattr(shims, "PROVIDERS", [])
    with pytest.raises(RuntimeError, match="no shim provider matches torch"):
        shims.get()


def test_record_function_is_a_range():
    with shims.get().record_function("probe"):
        x = torch.ones(3).sum()
    assert float(x) == 3.0


def test_identity_on_a_host_without_nvcc(fresh_shims, monkeypatch):
    monkeypatch.setattr(cuda_build, "nvcc_path_or_none", lambda: None)
    assert shims.get().identity() == \
        f"Torch2Shims-cuda{torch.version.cuda or 'none'}-nvccnone-sm_90a"


def test_identity_reads_the_nvcc_release_once(fresh_shims, monkeypatch,
                                              tmp_path):
    calls = tmp_path / "calls"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(f"#!/bin/sh\necho x >> {calls}\n"
                    "echo 'Cuda compilation tools, release 12.4, "
                    "V12.4.131'\n")
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(cuda_build, "nvcc_path_or_none", lambda: str(nvcc))
    a = shims.get().identity()
    b = shims.get().identity()
    assert a == b and "-nvcc12.4-" in a
    assert calls.read_text().count("x") == 1


def test_kernel_library_key_carries_the_identity(fresh_shims, monkeypatch):
    """The library's name, which is also its program-cache key, changes
    with the toolchain identity."""
    monkeypatch.setattr(cuda_build, "_PATHS", {})
    before = cuda_build.library_path("partition_reorder.cu")
    monkeypatch.setattr(shims.Torch2Shims, "identity",
                        lambda self: "Torch2Shims-cuda12.4-nvcc12.4-sm_90a")
    after = cuda_build.library_path("partition_reorder.cu")
    assert before != after
    assert before.parent == after.parent == cuda_build.BUILD_DIR
    assert os.path.basename(after).startswith("partition_reorder-")
