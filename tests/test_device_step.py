"""One device step for every backend and device count, its chunk-route
accounting, the CLI's --cuts modes, and the compile-cache placement."""

import io
import os
import subprocess
import sys

import pytest

from sickle_tpu.constants import QualityType
from sickle_tpu.engine import EngineConfig, run_se
from sickle_tpu.engine.hybrid import HybridCutsFn
from sickle_tpu.engine.pipeline import _device_cuts_fn, default_cuts_fn
from sickle_tpu.ops import TrimParams
from sickle_tpu.tools.synth_fastq import synth_fastq_bytes
from sickle_tpu.utils.metrics import Metrics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAMS = TrimParams(qualtype=QualityType.SANGER, qual_threshold=30)


def _is_device_step(fn):
    return (getattr(fn, "lazy", False) and callable(fn.warmup_aot)
            and callable(fn.prepare) and callable(fn.steps))


def test_default_cuts_fn_is_hybrid_wrapped_device_step():
    """On the CPU too, the default step is the lazy sliced device step
    (wire plans, uniform-length executables, AOT warmup) inside the
    hybrid router — the program a GPU runs, not a bare jit."""
    fn = default_cuts_fn(PARAMS)
    try:
        assert isinstance(fn, HybridCutsFn)
        assert _is_device_step(fn.device_fn)
        assert fn.warmup_aot == fn.device_fn.warmup_aot
    finally:
        fn.close()
    bare = default_cuts_fn(PARAMS, EngineConfig(hybrid=False))
    assert _is_device_step(bare)


def test_cli_builds_the_same_step_for_one_and_many_devices():
    """--devices 1 and --devices 8 (virtual CPU mesh) get the same
    hybrid-wrapped device step; only the mesh differs."""
    import jax

    from sickle_tpu import cli

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (virtual) devices")
    os.environ.pop("SICKLE_TPU_CUTS", None)
    built = []
    for devices, rpc_in, rpc_out in ((1, 1000, 1000), (8, 1000, 1000),
                                     (8, 1001, 1008)):
        fn, rpc = cli._build_cuts_fn(PARAMS, devices, rpc_in)
        built.append(fn)
        assert isinstance(fn, HybridCutsFn) and _is_device_step(fn.device_fn)
        assert rpc == rpc_out
    for fn in built:
        fn.close()


def test_cuts_host_builds_no_device_step():
    from sickle_tpu import cli

    try:
        assert cli._apply_cuts_mode("host") == "host"
        fn, _ = cli._build_cuts_fn(PARAMS, None, 1024)
        assert isinstance(fn, HybridCutsFn) and fn.device_fn is None
    finally:
        cli._apply_cuts_mode("auto")


def test_cuts_auto_restores_the_default_after_another_mode():
    """In-process runs (trim_all, the smoke script) switch --cuts modes
    one after another; 'auto' must not inherit 'device' or 'host'."""
    from sickle_tpu import cli

    for mode in ("device", "host", "hybrid"):
        cli._apply_cuts_mode(mode)
        assert cli._apply_cuts_mode("auto") == "auto"
        assert "SICKLE_TPU_CUTS" not in os.environ
        assert "SICKLE_TPU_HYBRID" not in os.environ
    assert cli._apply_cuts_mode("bogus") is None


@pytest.mark.parametrize("route", ["device", "host", "hybrid"])
def test_metrics_count_chunk_routes(route):
    data = synth_fastq_bytes(3000, seed=6)
    m = Metrics()
    if route == "device":
        fn = _device_cuts_fn(PARAMS, slice_rows=512)
    elif route == "host":
        fn = HybridCutsFn(PARAMS, None)
    else:
        fn = HybridCutsFn(PARAMS, _device_cuts_fn(PARAMS, slice_rows=512))
    try:
        run_se(io.BytesIO(data), io.BytesIO(), PARAMS,
               cfg=EngineConfig(records_per_chunk=512, slice_rows=512,
                                metrics=m), cuts_fn=fn)
        # a second run through the same fn counts only its own chunks
        m2 = Metrics()
        run_se(io.BytesIO(data), io.BytesIO(), PARAMS,
               cfg=EngineConfig(records_per_chunk=512, slice_rows=512,
                                metrics=m2), cuts_fn=fn)
    finally:
        getattr(fn, "close", lambda: None)()
    for mm in (m, m2):
        s = mm.summary()
        assert s["chunks"] == 6
        assert s["device_chunks"] + s["host_chunks"] == 6
        if route == "device":
            assert s["device_chunks"] == 6
        elif route == "host":
            assert s["host_chunks"] == 6 and s["device_chunks"] == 0
        assert 0 <= s["rescued_chunks"] <= s["host_chunks"]


def _cache_dir_in_subprocess(env_extra, code):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(env_extra, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    return r.stdout.strip().splitlines()[-1]


def test_compile_cache_follows_env_when_set(tmp_path):
    """JAX_COMPILATION_CACHE_DIR set: the package sets no directory of
    its own, and compiled programs land in the named one."""
    cache = tmp_path / "cache"
    code = (
        "import sickle_tpu, jax, jax.numpy as jnp\n"
        "jax.jit(lambda x: jnp.cumsum(x * 3))(jnp.arange(64))"
        ".block_until_ready()\n"
        "print(jax.config.jax_compilation_cache_dir)\n")
    got = _cache_dir_in_subprocess(
        {"JAX_COMPILATION_CACHE_DIR": str(cache),
         "JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS": "0",
         "JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES": "0"}, code)
    assert got == str(cache)
    assert cache.is_dir() and any(cache.iterdir())


def test_compile_cache_fixed_in_checkout_when_unset():
    import sickle_tpu

    got = _cache_dir_in_subprocess(
        {}, "import sickle_tpu, jax; "
            "print(jax.config.jax_compilation_cache_dir)")
    assert got == sickle_tpu.JAX_CACHE_DIR == os.path.join(REPO, ".jax_cache")
    ignored = subprocess.run(["git", "check-ignore", "-q", ".jax_cache/x"],
                             cwd=REPO)
    assert ignored.returncode in (0, 128)  # 128: not a git checkout
