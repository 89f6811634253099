"""The port's Ulysses attention (ddl_tpu_torch/parallel/ulysses.py) against
the JAX package's ``make_ulysses_self_attention`` on its CPU mesh, on the
same seeded inputs: causal and bidirectional, grouped-query K/V (the
all-to-all moves Hkv heads), a sliding window, the flash core inside
(the JAX kernels in interpret mode, the port's plain forward and
backward), the outputs and dQ/dK/dV under a random cotangent, and both
refusals (heads that do not split over ``seq``, K/V heads that do not),
message for message.

The port's ranks are real processes over gloo on the CPU, started by the
port's spawner: one world of four ranks builds the ``seq = 4`` mesh and
then the ``(data, seq) = (2, 2)`` one, each rank running this file as a
script (``_rank_main``, torch only).  Both sides are f32; the limits are
the ring's (the JAX package's ring tests'): outputs within 2e-5 absolute
and 1e-4 relative, gradients within 5e-5 absolute."""

import functools
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ddl_tpu_torch import launch
from ddl_tpu_torch.ops.flash_attention import flash_attention
from ddl_tpu_torch.parallel.mesh import SEQ_COMM, build_lm_mesh
from ddl_tpu_torch.parallel.sharding import LMMeshSpec
from ddl_tpu_torch.parallel.ulysses import ulysses_attention

HERE = Path(__file__).resolve()
B, T, H, D = 2, 32, 8, 8
OUT_ATOL, OUT_RTOL, GRAD_ATOL = 2e-5, 1e-4, 5e-5


def _case(n, causal=True, hkv=H, window=0, flash=False):
    return dict(n=n, causal=causal, hkv=hkv, window=window, flash=flash)


CASES = {
    "causal": _case(4),
    "bidirectional": _case(4, causal=False),
    "gqa": _case(4, hkv=4),
    "window": _case(4, hkv=4, window=12),
    "flash_causal": _case(4, flash=True),
    "flash_gqa_window": _case(4, hkv=4, window=12, flash=True),
    "ulysses2_gqa": _case(2, hkv=2),
}
# (q heads, K/V heads) that a seq axis of 4 refuses
REFUSED = {"heads": (6, 6), "kv_heads": (8, 2)}


def _inputs(name):
    """q, k, v (B, T, heads, D) and the output cotangent, f32 numpy."""
    c = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name))
    q = rng.normal(size=(B, T, H, D)).astype(np.float32)
    k, v = (rng.normal(size=(B, T, c["hkv"], D)).astype(np.float32) for _ in range(2))
    return q, k, v, rng.normal(size=(B, T, H, D)).astype(np.float32)


def _rank_main(out: str) -> None:
    """One rank of the four: every case on its mesh, this rank's output
    block and gradients, the exchanges' bytes, and the two refusals;
    saves ``rank<r>.pt``."""
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
        SEQ_COMM.update(all_to_all=0, bytes=0)
        o = ulysses_attention(q, k, v, mesh.seq_group, causal=c["causal"],
                              attn_fn=flash_attention if c["flash"] else None,
                              window=c["window"])
        (o * cot).sum().backward()
        result[name] = {"out": o.detach(), "dq": q.grad, "dk": k.grad, "dv": v.grad,
                        "seq_index": mesh.seq_index, "data_index": mesh.data_index,
                        "all_to_all": SEQ_COMM["all_to_all"], "bytes": SEQ_COMM["bytes"]}
    for name, (h, hkv) in REFUSED.items():
        q, kv = torch.zeros(B, T // 4, h, D), torch.zeros(B, T // 4, hkv, D)
        try:
            ulysses_attention(q, kv, kv, meshes[4].seq_group, causal=True)
        except ValueError as e:
            result[f"refusal_{name}"] = str(e)
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
    return _run(str(tmp_path_factory.mktemp("ulysses")))


def _jax_fn(n, causal, flash, window=0):
    import jax
    from jax.sharding import Mesh

    from ddl_tpu.ops.flash_attention import flash_attention as jax_flash
    from ddl_tpu.parallel.ulysses import make_ulysses_self_attention

    mesh = Mesh(np.array(jax.devices()[:n]), ("seq",))
    return make_ulysses_self_attention(mesh, causal=causal,
                                       attn_fn=jax_flash if flash else None, window=window)


@functools.cache
def _jax(name):
    """JAX's output and (dq, dk, dv) for the case's cotangent."""
    import jax
    import jax.numpy as jnp

    c = CASES[name]
    fn = _jax_fn(c["n"], c["causal"], c["flash"], c["window"])
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
def test_ulysses_matches_jax(ranks, name):
    want = _jax(name)
    rows = 2 if CASES[name]["n"] == 2 else 1
    for d in range(rows):  # each data row exchanges within itself on the same inputs
        got = [_assembled(ranks, name, key, d) for key in ("out", "dq", "dk", "dv")]
        np.testing.assert_allclose(got[0], want[0], atol=OUT_ATOL, rtol=OUT_RTOL)
        for g, w, what in zip(got[1:], want[1:], ("dq", "dk", "dv")):
            np.testing.assert_allclose(g, w, atol=GRAD_ATOL, err_msg=what)


@pytest.mark.parametrize("name", list(CASES))
def test_exchanges_move_kv_at_hkv_heads(ranks, name):
    """Four exchanges forward (q, k, v in, the output back) and four
    backward, each of this rank's whole block: K/V's at Hkv heads."""
    c = CASES[name]
    block = B * (T // c["n"]) * D * 4
    for r in ranks:
        assert r[name]["all_to_all"] == 8
        assert r[name]["bytes"] == 2 * block * (2 * H + 2 * c["hkv"])


@pytest.mark.parametrize("refusal", list(REFUSED))
def test_refusals_match_jax(ranks, refusal):
    import jax.numpy as jnp

    h, hkv = REFUSED[refusal]
    q, kv = jnp.zeros((B, T, h, D)), jnp.zeros((B, T, hkv, D))
    with pytest.raises(ValueError) as want:
        _jax_fn(4, True, False)(q, kv, kv)
    assert all(r[f"refusal_{refusal}"] == str(want.value) for r in ranks)


if __name__ == "__main__":
    _rank_main(sys.argv[1])
