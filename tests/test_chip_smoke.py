"""chip_smoke.py on the CPU: its device gate, and each phase at a small size.

On the card the script runs these same phase functions at the deployment
sizes; here they run on the CPU backend (the mesh phase on 4 of the virtual
CPU devices), with every bit-exact check unchanged.
"""

import os
import subprocess
import sys

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_gate_refuses_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout
    assert "needs a GPU" in p.stderr


def test_ntt_phase_small():
    out = chip_smoke.phase_ntt(shapes=((8, 2, 2),), reps=1)
    assert list(out) == ["n=2^8 dim=2 batch=2"]


def test_scheme_phase_small_replays_golden_logn11():
    """Reference-binary golden replay (tests/golden/golden_logn11.json),
    mul_rs, mul_rs_batch bit-identity, rot/conj and the reconstruct oracle
    at logn=11 (Delta=2^20, so the decode gate is 1e-3, see test_golden)."""
    res = chip_smoke.phase_scheme(dict(
        logn=11, logq=48, slots=4, logDelta=20, golden="logn11", tol=1e-3,
        batch=2, reps=1))
    assert res["mul_rs_ms"] > 0


def test_mesh_phase_small_bit_exact():
    """Sharded mul_rs/rot on a (limb=2, coeff=2) mesh of 4 virtual CPU
    devices, bit-identical to the single-device engine."""
    res = chip_smoke.phase_mesh(dict(logn=6, logq=110, slots=4, logDelta=30,
                                     tol=1e-5, reps=1))
    assert set(res) >= {"sharded_mul_rs_ms", "meshckks_rot_ms"}
