"""Multi-host bootstrap (raytpu.parallel.distributed).

The reference's process-level init is the OpenMP thread probe
(`raytracer/Source/raytracer.cpp:118-136`); ours is
jax.distributed.initialize(). No cluster exists in CI, so we exercise:

  * the single-process no-op resolution (clean env -> disabled state),
  * env-variable resolution precedence,
  * the DEGENERATE EXPLICIT 1-process bootstrap — the full coordinator
    service bring-up on localhost, run in a subprocess because
    jax.distributed.initialize must precede backend initialization.
"""

from __future__ import annotations

import os
import subprocess
import sys
import textwrap

import pytest


def _clean_env(monkeypatch):
    for k in ("RAYTPU_COORDINATOR", "JAX_COORDINATOR_ADDRESS",
              "RAYTPU_NUM_PROCESSES", "RAYTPU_PROCESS_ID",
              "SLURM_JOB_ID", "OMPI_COMM_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)


def test_single_process_noop(monkeypatch):
    import raytpu.parallel.distributed as dist

    _clean_env(monkeypatch)
    monkeypatch.setattr(dist, "_STATE", None)
    state = dist.init_distributed()
    assert not state.enabled
    assert state.num_processes == 1
    assert state.process_id == 0
    assert state.is_coordinator
    # Idempotent: second call returns the same state object.
    assert dist.init_distributed() is state
    dist.shutdown_distributed()


def test_env_resolution_is_read(monkeypatch):
    """RAYTPU_* env marks the run explicit (would initialize); verify the
    resolution logic sees it without bringing the service up in-process."""
    import raytpu.parallel.distributed as dist

    _clean_env(monkeypatch)
    monkeypatch.setattr(dist, "_STATE", None)
    calls = {}

    def fake_init(**kw):
        calls.update(kw)

    monkeypatch.setattr(dist.jax.distributed, "initialize", fake_init)
    monkeypatch.setattr(dist.jax, "process_count", lambda: 3)
    monkeypatch.setattr(dist.jax, "process_index", lambda: 2)
    monkeypatch.setenv("RAYTPU_COORDINATOR", "10.0.0.1:8476")
    monkeypatch.setenv("RAYTPU_NUM_PROCESSES", "3")
    monkeypatch.setenv("RAYTPU_PROCESS_ID", "2")
    state = dist.init_distributed()
    assert calls["coordinator_address"] == "10.0.0.1:8476"
    assert calls["num_processes"] == 3
    assert calls["process_id"] == 2
    assert state.enabled and state.num_processes == 3
    assert state.process_id == 2 and not state.is_coordinator
    monkeypatch.setattr(dist, "_STATE", None)


def test_degenerate_single_process_bootstrap():
    """Full coordinator bring-up with num_processes=1 on localhost —
    the same code path a pod run takes (fresh interpreter: initialize
    must precede backend init)."""
    prog = textwrap.dedent("""
        import jax
        jax.config.update("jax_platforms", "cpu")
        from raytpu.parallel import init_distributed, shutdown_distributed
        state = init_distributed(num_processes=1)
        assert state.enabled, state
        assert state.num_processes == 1
        assert state.process_id == 0
        assert jax.process_count() == 1
        # Devices are live and usable after bootstrap.
        import jax.numpy as jnp
        assert float(jnp.arange(4.0).sum()) == 6.0
        shutdown_distributed()
        print("DEGENERATE_OK")
    """)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-c", prog], capture_output=True, text=True,
        timeout=180, env=env,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "DEGENERATE_OK" in proc.stdout


def test_two_process_psum_and_train_step():
    """REAL multi-process execution (round-3 verdict item 4): 2 localhost
    processes x 4 virtual CPU devices, gloo collectives (the DCN
    stand-in). Proves the jax.distributed + shard_map composition: a
    cross-process psum over the full data axis and one sharded
    inverse-rendering train step, with the replicated loss agreeing
    bit-for-bit across processes."""
    from raytpu.parallel.mp_dryrun import launch

    results = launch(num_processes=2, devices_per_process=4, timeout=420)
    assert len(results) == 2
    for r in results:
        assert r["global_devices"] == 8
        assert r["mesh"] == {"data": 4, "model": 2}
        assert r["psum"] == 6.0  # sum over data-axis indices 0+1+2+3
    assert results[0]["loss"] == results[1]["loss"]
