"""Genuine 2-process jax.distributed integration test (CPU backend).

Spawns a coordinator (process 0) and a worker (process 1), each with one
CPU device; the outer mesh axis spans the two processes and the sharded HE
sum's all_gather crosses the process boundary for real.  This exercises
the one code path a single process cannot: distributed.initialize ->
global mesh -> cross-process collective -> verified decrypt.

The reference's closest analog is pickling ciphertexts between processes
(its example/ipclpy_example.py); here the runtime
moves them over the collective fabric instead.
"""

import os
import socket
import subprocess
import sys

import pytest

_HERE = os.path.dirname(os.path.abspath(__file__))


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_he_sum():
    port = _free_port()
    procs = []
    for pid in range(2):
        env = dict(os.environ)
        env.pop("XLA_FLAGS", None)          # conftest's 8-device forcing
        # the workers stay on the plain CPU backend, whatever devices
        # the parent's environment points at
        env.pop("PYTHONPATH", None)
        env.update({
            "JAX_PLATFORMS": "cpu",
            "XLA_FLAGS": "--xla_force_host_platform_device_count=1",
            "JAX_CPU_COLLECTIVES_IMPLEMENTATION": "gloo",
            "PAILLIER_COORDINATOR": f"127.0.0.1:{port}",
            "PAILLIER_NUM_PROCESSES": "2",
            "PAILLIER_PROCESS_ID": str(pid),
        })
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(_HERE, "_dist_worker.py")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=240)
            outs.append((p.returncode, out, err))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        raise
    for rc, out, err in outs:
        assert rc == 0, f"worker failed rc={rc}\nstdout:{out}\nstderr:{err}"
    assert any("RESULT " in out for _, out, _ in outs), outs
