"""The port's ring attention (ddl_tpu_torch/parallel/ring_attention.py)
against the JAX package's ``make_ring_self_attention`` on its CPU mesh,
on the same seeded inputs: causal and bidirectional, grouped-query K/V, a
sliding window shorter than the ring (the hops cut at ``ceil((window +
T_local - 1) / T_local)``), flash inside the ring (the JAX kernels in
interpret mode, the port's plain forward and backward with the lse
cotangent of the logsumexp combine), the outputs and dQ/dK/dV under a
random cotangent, and the refusal of a window without causality.

The port's ranks are real processes over gloo on the CPU, started by the
port's spawner: one world of four ranks builds the ``seq = 4`` mesh and
then the ``(data, seq) = (2, 2)`` one (two rings of two, each data row on
the same inputs), and each runs this file as a script (``_rank_main``,
torch only).  Both sides are f32; the limits are the JAX package's own ring
tests' (``tests/test_ring_attention.py``): outputs within 2e-5 absolute
and 1e-4 relative, gradients within 5e-5 absolute (measured ~1e-6)."""

import functools
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ddl_tpu_torch import launch
from ddl_tpu_torch.parallel.mesh import SEQ_COMM, build_lm_mesh
from ddl_tpu_torch.parallel.ring_attention import ring_attention
from ddl_tpu_torch.parallel.sharding import LMMeshSpec

HERE = Path(__file__).resolve()
B, T, H, D = 2, 32, 4, 8
OUT_ATOL, OUT_RTOL, GRAD_ATOL = 2e-5, 1e-4, 5e-5


def _case(n, causal=True, hkv=H, window=0, flash=False):
    return dict(n=n, causal=causal, hkv=hkv, window=window, flash=flash)


CASES = {
    "causal": _case(4),
    "bidirectional": _case(4, causal=False),
    "gqa": _case(4, hkv=2),
    "window": _case(4, hkv=2, window=12),
    "flash_causal": _case(4, flash=True),
    "flash_bidirectional": _case(4, causal=False, flash=True),
    "flash_gqa_window": _case(4, hkv=2, window=12, flash=True),
    "ring2_causal": _case(2, hkv=2),
    "ring2_flash_window": _case(2, window=20, flash=True),
}


def _inputs(name):
    """q, k, v (B, T, heads, D) and the output cotangent, f32 numpy."""
    c = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name))
    q = rng.normal(size=(B, T, H, D)).astype(np.float32)
    k, v = (rng.normal(size=(B, T, c["hkv"], D)).astype(np.float32) for _ in range(2))
    return q, k, v, rng.normal(size=(B, T, H, D)).astype(np.float32)


def _hops(c) -> int:
    t = T // c["n"]
    return min(c["n"], -(-(c["window"] + t - 1) // t)) if c["window"] else c["n"]


def _rank_main(out: str) -> None:
    """One rank of the four: every case on its mesh, this rank's output
    block and gradients, and the ring's transfers; saves ``rank<r>.pt``."""
    launch.bootstrap("cpu")
    meshes = {4: build_lm_mesh(LMMeshSpec(seq=4), "cpu"),
              2: build_lm_mesh(LMMeshSpec(data=2, seq=2), "cpu")}
    result = {}
    for name, c in CASES.items():
        mesh = meshes[c["n"]]
        t = T // c["n"]
        cols = slice(mesh.seq_index * t, (mesh.seq_index + 1) * t)
        q, k, v, cot = (torch.from_numpy(a[:, cols].copy()) for a in _inputs(name))
        q, k, v = (x.requires_grad_() for x in (q, k, v))
        SEQ_COMM.update(ppermute=0, bytes=0)
        o = ring_attention(q, k, v, mesh.seq_group, causal=c["causal"], use_flash=c["flash"],
                           window=c["window"])
        (o * cot).sum().backward()
        result[name] = {"out": o.detach(), "dq": q.grad, "dk": k.grad, "dv": v.grad,
                        "seq_index": mesh.seq_index, "data_index": mesh.data_index,
                        "ppermute": SEQ_COMM["ppermute"], "bytes": SEQ_COMM["bytes"]}
    x = torch.zeros(B, T // 4, H, D)
    try:
        ring_attention(x, x, x, meshes[4].seq_group, causal=False, window=4)
    except ValueError as e:
        result["refusal"] = str(e)
    torch.save(result, Path(out) / f"rank{torch.distributed.get_rank()}.pt")
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


@functools.cache
def _run(root: str):
    Path(root).mkdir(parents=True, exist_ok=True)
    code = launch.spawn_local([sys.executable, str(HERE), root], 4,
                              env=dict(os.environ, OMP_NUM_THREADS="1",
                                       PYTHONPATH=str(HERE.parents[1])),
                              log_dir=Path(root) / "logs", timeout_s=600)
    assert code == 0, (Path(root) / "logs" / "rank0.log").read_text()[-3000:]
    return [torch.load(Path(root) / f"rank{r}.pt", weights_only=False) for r in range(4)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return _run(str(tmp_path_factory.mktemp("ring_attention")))


@functools.cache
def _jax(name):
    """JAX's output and (dq, dk, dv) for the case's cotangent."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from ddl_tpu.parallel.ring_attention import make_ring_self_attention

    c = CASES[name]
    mesh = Mesh(np.array(jax.devices()[:c["n"]]), ("seq",))
    fn = make_ring_self_attention(mesh, causal=c["causal"], use_flash=c["flash"],
                                  window=c["window"])
    q, k, v, cot = (jnp.asarray(a) for a in _inputs(name))
    out, vjp = jax.vjp(fn, q, k, v)
    return (np.asarray(out), *(np.asarray(g) for g in vjp(cot)))


def _assembled(ranks_out, name, key, data_index):
    """The case's ``key`` over the whole sequence from one data row's
    ranks, in seq order."""
    rows = sorted((r[name]["seq_index"], r[name][key]) for r in ranks_out
                  if r[name]["data_index"] == data_index)
    return torch.cat([x for _, x in rows], dim=1).numpy()


@pytest.mark.parametrize("name", list(CASES))
def test_ring_matches_jax(ranks, name):
    want = _jax(name)
    rows = 2 if CASES[name]["n"] == 2 else 1
    for d in range(rows):  # each data row runs its own ring on the same inputs
        got = [_assembled(ranks, name, key, d) for key in ("out", "dq", "dk", "dv")]
        np.testing.assert_allclose(got[0], want[0], atol=OUT_ATOL, rtol=OUT_RTOL)
        for g, w, what in zip(got[1:], want[1:], ("dq", "dk", "dv")):
            np.testing.assert_allclose(g, w, atol=GRAD_ATOL, err_msg=what)


@pytest.mark.parametrize("name", list(CASES))
def test_hops_carry_kv_heads_and_stop_at_the_window(ranks, name):
    """Each rotation moves one K or V block at Hkv heads, forward and
    backward; a window cuts the ring at its last reachable hop."""
    c = CASES[name]
    hops = _hops(c)
    if name in ("window", "flash_gqa_window"):
        assert hops < c["n"]
    block = B * (T // c["n"]) * c["hkv"] * D * 4
    for r in ranks:
        assert r[name]["ppermute"] == 4 * (hops - 1)
        assert r[name]["bytes"] == 4 * (hops - 1) * block


def test_window_without_causal_is_refused_as_in_jax(ranks):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from ddl_tpu.parallel.ring_attention import make_ring_self_attention

    x = jnp.zeros((B, T, H, D))
    fn = make_ring_self_attention(Mesh(np.array(jax.devices()[:4]), ("seq",)), window=4)
    with pytest.raises(ValueError) as want:
        fn(x, x, x)
    assert all(r["refusal"] == str(want.value) for r in ranks)


if __name__ == "__main__":
    _rank_main(sys.argv[1])
