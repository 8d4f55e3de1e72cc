"""Multi-process (multi-host analogue) distribution tests.

SURVEY.md §5 names collectives across hosts as the JAX equivalent
of a distributed backend.  tools/mp_mul_rs.py runs the fused mul_rs program
over a (limb, coeff, batch) = (2, 2, 2) mesh spanning TWO OS processes
(jax.distributed + gloo CPU collectives, 4 virtual devices each), with keys
and ciphertexts exchanged through utils/serialize, and asserts bit-exactness
against the single-device engine.  This test shells out to the launcher so
the distributed runtime initializes in clean processes (it cannot coexist
with this pytest process's own jax session).
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_two_process_sharded_mul_rs():
    env = dict(os.environ)
    env["MP_PORT"] = "9931"
    # the launcher's workers set their own JAX/XLA env
    env.pop("XLA_FLAGS", None)
    p = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "mp_mul_rs.py")],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=570)
    assert p.returncode == 0, f"stdout:\n{p.stdout}\nstderr:\n{p.stderr[-2000:]}"
    assert "PASS (bit-exact across 2 processes)" in p.stdout
