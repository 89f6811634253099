"""The port's int8 quality tool (ddl_tpu_torch/bench/decode_quality.py)
against the JAX package's on one set of weights: the JAX trainer trains a
tiny byte LM on a corpus and saves it; the port trainer loads those
parameters (``lm_params_from_jax``) and saves them too; each tool reads
its own package's snapshot.  The ``heldout_ppl`` line's ``exact`` and
``int8_weights`` agree within 1e-5 relative (f32 on both sides, the same
math in another summation order, then the tools' own rounding to 4
decimals), and both kinds of line carry the JAX tool's keys.  Also the
tool's refusals."""

import json
import sys
from contextlib import redirect_stdout
from io import StringIO

import jax
import numpy as np
import optax
import pytest
import torch

from ddl_tpu.bench import decode_quality as jax_decode_quality
from ddl_tpu.models.transformer import LMConfig as JaxLMConfig
from ddl_tpu.parallel.sharding import LMMeshSpec as JaxMeshSpec
from ddl_tpu.train.lm_trainer import LMRunConfig as JaxRunConfig
from ddl_tpu.train.lm_trainer import LMTrainer as JaxLMTrainer
from ddl_tpu.utils import compile_cache as jax_compile_cache
from ddl_tpu_torch import checkpoint as ckpt
from ddl_tpu_torch.bench import decode_quality
from ddl_tpu_torch.data.lm_corpus import encode_text_file
from ddl_tpu_torch.models.convert import lm_params_from_jax
from ddl_tpu_torch.models.transformer import LMConfig
from ddl_tpu_torch.parallel.sharding import LMMeshSpec
from ddl_tpu_torch.train.lm_trainer import LMRunConfig, LMTrainer
from ddl_tpu_torch.train.state import Optimizer

D_MODEL, LAYERS, HEADS, KV_HEADS = 32, 2, 4, 2
CFG = dict(vocab_size=256, d_model=D_MODEL, n_layers=LAYERS, n_heads=HEADS, n_kv_heads=KV_HEADS,
           head_dim=D_MODEL // HEADS, d_ff=4 * D_MODEL, compute_dtype="float32", remat=False)
RUN = dict(batch=4, seq_len=16, steps=6, log_every=3, save_every=6, job_id="lm-q",
           log_dir=None)
STEP = 6
PPL_RTOL = 1e-5
FLAGS = ["--job-id", "lm-q", "--step", str(STEP), "--d-model", str(D_MODEL), "--layers",
         str(LAYERS), "--heads", str(HEADS), "--kv-heads", str(KV_HEADS), "--seq-len", "16",
         "--eval-frac", "0.25", "--eval-batches", "4", "--batch", "4", "--prompt-len", "8",
         "--max-new", "6", "--gen-batches", "2"]
JAX_KEYS = {
    "heldout_ppl": {"metric", "exact", "int8_weights", "ppl_delta_pct", "eval_tokens"},
    "greedy_agreement": {"metric", "quant", "token_match_rate", "sequences", "max_new",
                         "median_first_divergence", "fully_agreed_frac"},
}


def _lines(text: str) -> list[dict]:
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


@pytest.fixture(scope="module")
def snapshots(tmp_path_factory):
    """(root, corpus .npy): the JAX run's snapshot under ``root/jax`` and
    the same parameters saved by the port trainer under ``root/port``."""
    root = tmp_path_factory.mktemp("decode_quality")
    text = root / "corpus.txt"
    text.write_bytes(np.random.default_rng(7).integers(0, 256, 2000, dtype=np.uint8).tobytes())
    npy = str(encode_text_file(str(text), str(root / "corpus.npy")))
    jax_t = JaxLMTrainer(JaxLMConfig(**CFG), JaxMeshSpec(), optax.adamw(1e-3),
                         JaxRunConfig(**RUN, corpus=npy, checkpoint_dir=str(root / "jax")),
                         jax.random.key(0))
    jax_t.train()
    port = LMTrainer(LMConfig(**CFG), LMMeshSpec(), lambda p: Optimizer(p, 1e-3),
                     LMRunConfig(**{**RUN, "steps": 1}, corpus=npy,
                                 checkpoint_dir=str(root / "port")), device="cpu")
    port.state.model.load_state_dict(lm_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jax.device_get(jax_t.state.params))))
    port.state.step = STEP
    port.save_snapshot(0)
    return root, npy


@pytest.fixture(scope="module")
def lines(snapshots, tmp_path_factory):
    """Each tool's JSON lines on its own package's snapshot."""
    root, npy = snapshots
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        # the JAX tool would point this process's compile cache elsewhere
        mp.setattr(jax_compile_cache, "enable_compile_cache", lambda: None)
        mp.setattr(sys, "argv", ["decode_quality", "--checkpoint-dir", str(root / "jax"),
                                 "--corpus", npy, *FLAGS])
        for name, run in (("jax", jax_decode_quality.main),
                          ("port", lambda: decode_quality.main(
                              ["--checkpoint-dir", str(root / "port"), "--corpus", npy,
                               *FLAGS, "--device", "cpu"]))):
            buf = StringIO()
            with redirect_stdout(buf):
                run()
            out[name] = _lines(buf.getvalue())
    return out


def test_heldout_ppl_matches_jax(lines):
    got, want = lines["port"][0], lines["jax"][0]
    assert got["metric"] == want["metric"] == "heldout_ppl"
    for key in ("exact", "int8_weights"):
        np.testing.assert_allclose(got[key], want[key], rtol=PPL_RTOL, err_msg=key)
    assert got["eval_tokens"] == want["eval_tokens"] == 4 * 4 * 16
    assert np.isfinite(got["ppl_delta_pct"])


def test_lines_carry_the_jax_keys(lines):
    for side in ("port", "jax"):
        assert [line["metric"] for line in lines[side]] == [
            "heldout_ppl", "greedy_agreement", "greedy_agreement"]
        assert [line.get("quant") for line in lines[side][1:]] == ["kv", "kv+w"]
        for line in lines[side]:
            assert set(line) == JAX_KEYS[line["metric"]]
    for got, want in zip(lines["port"][1:], lines["jax"][1:]):
        assert (got["sequences"], got["max_new"]) == (want["sequences"], want["max_new"]) == (8, 6)
        assert 0.0 <= got["token_match_rate"] <= 1.0


def test_refusals(snapshots, tmp_path):
    root, npy = snapshots
    base = ["--checkpoint-dir", str(root / "port"), "--corpus", npy, *FLAGS]
    with pytest.raises(SystemExit, match="held-out split"):
        decode_quality.main(base + ["--eval-frac", "0.01", "--device", "cpu"])
    # a snapshot in the JAX package's pipeline layout (stacked "blocks")
    state = ckpt.load_snapshot(root / "port", "lm-q", STEP)[0]
    state["model"] = {("blocks." + k if k.startswith("block") else k): v
                      for k, v in state["model"].items()}
    ckpt.save_snapshot(tmp_path, "lm-q", STEP, state)
    with pytest.raises(SystemExit, match="pipeline-parallel layout.*never writes one"):
        decode_quality.main(["--checkpoint-dir", str(tmp_path), "--corpus", npy, *FLAGS,
                             "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            decode_quality.main(base)

