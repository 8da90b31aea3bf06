"""The port's analyzer (``spark_rapids_tpu_torch.analysis``) against the JAX
package's, rule by rule.

The engine rules (R006, R008-R015) mean the same in both packages: every
fixture test of ``tests/test_analysis.py`` for them runs as written against
the JAX analyzer, each of its analyses is recorded, and the same sources
(the package name in paths and texts renamed) go through the port's
analyzer, which must give the same findings: rule, path, line and message.
R002 and R007 check PyTorch's syncs and the CUDA kernel libraries, and
R016-R018 the port's cache route, on torch fixtures; R001 and R003 have no
counterpart and are listed as not ported."""
import inspect
import json
import re
import textwrap

import pytest

import test_analysis as ta
from spark_rapids_tpu.analysis import analyze_files as jax_analyze
from spark_rapids_tpu_torch.analysis import SourceFile, analyze_files
from spark_rapids_tpu_torch.analysis.__main__ import main

#: the fixture tests of the engine rules, run as written (those that take
#: pytest fixtures or lint a whole package are covered elsewhere)
_ENGINE = re.compile(r"test_r0(06|08|09|10|11|12|13|14|15)_")
ENGINE_CASES = sorted(
    name for name, fn in vars(ta).items()
    if _ENGINE.match(name) and callable(fn)
    and not inspect.signature(fn).parameters and "package" not in name)


def _port(text: str) -> str:
    return re.sub(r"spark_rapids_tpu(?!_torch)", "spark_rapids_tpu_torch",
                  text)


def _rows(findings, rename=lambda s: s):
    return [(f.rule, rename(f.path), f.line, rename(f.message))
            for f in findings]


def test_every_engine_rule_has_cases():
    rules = {re.match(r"test_(r\d+)_", n).group(1) for n in ENGINE_CASES}
    assert rules == {"r006", "r008", "r009", "r010", "r011", "r012",
                     "r013", "r014", "r015"}
    assert len(ENGINE_CASES) >= 60


@pytest.mark.parametrize("name", ENGINE_CASES)
def test_engine_rule_fixture_same_findings_in_both(name, monkeypatch):
    calls = []

    def recording(files, rule_ids=None, **kw):
        res = jax_analyze(files, rule_ids=rule_ids, **kw)
        calls.append((list(files), rule_ids, kw, res.findings))
        return res
    monkeypatch.setattr(ta, "analyze_files", recording)
    getattr(ta, name)()
    assert calls, f"{name} ran no analysis"
    for files, rule_ids, kw, want in calls:
        ported = [SourceFile(_port(f.path), _port(f.text),
                             _port(f.display_path)) for f in files]
        got = analyze_files(ported, rule_ids=rule_ids, **kw).findings
        assert _rows(got) == _rows(want, _port)


# -------------------------------------------------------------- torch rules
def _run(text: str, path: str, rules):
    s = SourceFile(path, textwrap.dedent(text), path)
    return analyze_files([s], rule_ids=set(rules)).findings


HOT = "spark_rapids_tpu_torch/ops/foo.py"


def test_r002_sync_methods_flagged_in_hot_path():
    found = _run("""
        import torch
        def g(x):
            torch.cuda.synchronize()
            return x.item(), x.tolist(), x.cpu(), x.numpy()
        """, HOT, {"R002"})
    kinds = sorted(f.message.split(" ")[0] for f in found)
    assert kinds == [".cpu()", ".item()", ".numpy()", ".tolist()",
                     "torch.cuda.synchronize()"]


def test_r002_scalar_cast_of_device_value_in_loop():
    found = _run("""
        import numpy as np
        import torch
        def f(batches):
            for b in batches:
                n = int(torch.count_nonzero(b))
                t = torch.cumsum(b, 0)
                k = int(t[-1])
                m = int(t.sum())
                h = np.asarray([1, 2])
                q = int(h.sum())
                r = int(np.prod(h))
                yield n, k, m, q, r
        """, HOT, {"R002"})
    assert [f.line for f in found] == [6, 8, 9]
    assert all("inside a loop" in f.message for f in found)


def test_r002_clean_outside_loop_and_outside_hot_path():
    text = """
        import torch
        def f(b):
            return int(torch.count_nonzero(b))
        def g(b):
            return b.cpu()
        """
    # the cast outside a loop is not flagged; the copy is, anywhere
    assert [f.line for f in _run(text, HOT, {"R002"})] == [6]
    assert _run(text, "spark_rapids_tpu_torch/columnar/foo.py",
                {"R002"}) == []


def test_r002_rebinding_to_host_clears_the_taint():
    found = _run("""
        import torch
        def f(batches):
            t = torch.arange(4)
            t = [1, 2, 3]
            for b in batches:
                yield int(t[0])
        """, HOT, {"R002"})
    assert found == []


def test_r002_suppression_applies():
    found = _run("""
        def f(x):
            # the designed read  # tpu-lint: disable=R002
            return x.tolist()
        """, HOT, {"R002"})
    assert found == []


LOAD = "spark_rapids_tpu_torch/shuffle/kern.py"


def test_r007_library_bound_outside_the_cache_flagged():
    found = _run("""
        import ctypes
        from spark_rapids_tpu_torch import cuda_build
        def launch(x):
            lib = ctypes.CDLL(str(cuda_build.build("k.cu")[0]))
            return lib.run(x)
        """, LOAD, {"R007"})
    assert [(f.line, f.message.split("(")[0]) for f in found] == \
        [(5, "ctypes.CDLL"), (5, "cuda_build.build")]
    assert all("program cache" in f.message for f in found)


def test_r007_builder_handed_to_the_cache_clean():
    found = _run("""
        import ctypes
        from spark_rapids_tpu_torch.serving.program_cache import \\
            global_program_cache
        def load(source, name):
            def builder():
                return ctypes.CDLL(name)
            cache = global_program_cache()
            return cache.get_or_build(("lib", source, name), builder).fn
        def load_lambda(cache, name):
            return cache.get_or_build(("lib", name),
                                      lambda: ctypes.CDLL(name)).fn
        """, LOAD, {"R007"})
    assert found == []


def test_r007_builder_not_handed_to_the_cache_flagged():
    found = _run("""
        import ctypes
        def load(cache, name):
            def builder():
                return ctypes.CDLL(name)
            lib = builder()
            return cache.get_or_build(("lib", name), lambda: lib).fn
        """, LOAD, {"R007"})
    assert [f.line for f in found] == [5]


def test_r007_program_cache_module_is_exempt():
    text = """
        import ctypes
        def load(name):
            return ctypes.CDLL(name)
        """
    assert _run(text, "spark_rapids_tpu_torch/serving/program_cache.py",
                {"R007"}) == []
    assert len(_run(text, LOAD, {"R007"})) == 1


def test_r016_builder_capture_the_key_misses_flagged():
    """The kind of fault the toolchain key repaired: a library builder
    that reads a value (here the compiler flags) its key does not carry
    serves the library built under the old value."""
    stale = """
        import ctypes
        def load(cache, source, flags):
            key = ("cuda_library", source)
            def builder():
                return ctypes.CDLL(build(source, flags))
            return cache.get_or_build(key, builder).fn
        def build(source, flags):
            return source
        """
    found = _run(stale, LOAD, {"R016"})
    assert len(found) == 1 and "'flags'" in found[0].message
    keyed = stale.replace('("cuda_library", source)',
                          '("cuda_library", source, flags)')
    assert _run(keyed, LOAD, {"R016"}) == []


def test_r017_mutated_global_captured_by_a_cached_launcher_flagged():
    found = _run("""
        TABLE = {}
        def register(k, v):
            TABLE[k] = v
        def launcher(cache, key, lib):
            def build():
                def fn(x):
                    return lib.launch(x, len(TABLE))
                return fn
            return cache.get_or_build(key, build).fn
        """, LOAD, {"R017"})
    assert len(found) == 1 and "'TABLE'" in found[0].message


def test_r018_effect_in_a_cached_launcher_flagged():
    found = _run("""
        def launcher(cache, key, lib, metrics):
            def build():
                def fn(x):
                    metrics.add(1)
                    return lib.launch(x)
                return fn
            return cache.get_or_build(key, build).fn
        """, LOAD, {"R018"})
    assert len(found) == 1 and "metric bump" in found[0].message


def test_list_rules_marks_r001_r003_not_ported(capsys):
    assert main(["--list-rules"]) == 0
    out = capsys.readouterr().out.splitlines()
    ported = {ln.split()[0] for ln in out if "[not ported]" not in ln}
    assert {ln.split()[0] for ln in out if "[not ported]" in ln} == \
        {"R001", "R003"}
    assert ported == {f"R{i:03d}" for i in range(2, 19)} - {"R003"}


def test_json_format_over_a_fixture(tmp_path, capsys):
    d = tmp_path / "ops"
    d.mkdir()
    (d / "foo.py").write_text("def f(x):\n    return x.item()\n")
    assert main([str(d), "--format", "json", "--rules", "R002"]) == 1
    doc = json.loads(capsys.readouterr().out)
    assert [f["rule"] for f in doc["findings"]] == ["R002"]
