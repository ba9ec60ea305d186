"""The backend decision point (utils/platform.py) and the measurement
entry points' refusal to run without a GPU."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from stereomatching.utils import platform

REPO = os.path.join(os.path.dirname(__file__), "..")


@pytest.mark.parametrize("stage,backend,want", [
    ("classic_match", "gpu", "fused"),
    ("classic_match", "cpu", "xla"),
    ("box_sum", "gpu", "matmul"),
    ("box_sum", "cpu", "sat"),
])
def test_implementation_table(stage, backend, want):
    assert platform.implementation(stage, backend) == want


@pytest.mark.parametrize("stage", ["classic_match", "box_sum"])
def test_implementation_defaults_to_running_backend(stage):
    assert platform.implementation(stage) == platform.implementation(
        stage, jax.default_backend())


@pytest.mark.parametrize("backend", ["tpu", "rocm", "metal"])
def test_unknown_backend_is_an_error(backend):
    with pytest.raises(RuntimeError, match="no implementation"):
        platform.implementation("classic_match", backend)


def test_unknown_stage_is_an_error():
    with pytest.raises(KeyError):
        platform.implementation("sgm_aggregate", "gpu")


def test_require_gpu_refuses_the_cpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        platform.require_gpu()


def test_card_info_reads_nvidia_smi(monkeypatch):
    calls = []

    class Done:
        stdout = "NVIDIA H100 80GB HBM3, 700.00 W\n"

    def fake_run(cmd, **kw):
        calls.append(cmd)
        return Done()

    monkeypatch.setattr(subprocess, "run", fake_run)
    assert platform.card_info() == "NVIDIA H100 80GB HBM3, 700.00 W"
    assert calls == [["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"]]


@pytest.mark.parametrize("env_dir", [None, "/somewhere/else"])
def test_compile_cache_placement(monkeypatch, env_dir):
    """Only when JAX_COMPILATION_CACHE_DIR is unset does the program set
    a directory: the fixed one at the root of the checkout."""
    updates = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: updates.__setitem__(k, v))
    if env_dir is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env_dir)
    platform.ensure_compile_cache()
    if env_dir is None:
        want = os.path.join(os.path.abspath(REPO), ".jax_cache")
        assert updates["jax_compilation_cache_dir"] == want
    else:
        assert "jax_compilation_cache_dir" not in updates
    assert updates["jax_persistent_cache_min_compile_time_secs"] == 1.0


def test_compile_cache_dir_is_git_ignored():
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


@pytest.mark.parametrize("shape,half", [((30, 41), 2), ((2, 25, 33), 4),
                                        ((47, 47), 10), ((3, 9, 64), 0)])
def test_box_sum_choices_agree(monkeypatch, shape, half):
    """Whichever box filter the decision point names, the sums are the
    same bits (bf16 operands, f32 accumulation: exact on 0/1 input)."""
    from stereomatching.ops import aggregate

    rng = np.random.default_rng(sum(shape) + half)
    padded = jnp.asarray(rng.integers(0, 2, shape), jnp.int32)
    want = aggregate.box_sum_padded(padded, half)
    monkeypatch.setitem(platform._IMPLEMENTATIONS["box_sum"],
                        jax.default_backend(), "matmul")
    got = aggregate.box_sum_padded_auto(padded, half)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _run(args, cwd=REPO, timeout=300):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


@pytest.mark.parametrize("script", ["bench.py", "tools/classic_routes.py"])
def test_measurements_refuse_to_run_without_gpu(script):
    r = _run([os.path.join(REPO, script), "--size", "32"])
    assert r.returncode != 0
    assert "pairs" not in r.stdout


def test_dryrun_multichip_refuses_too_few_devices():
    import __graft_entry__ as ge

    with pytest.raises(RuntimeError, match="need 16 devices"):
        ge.dryrun_multichip(16)
