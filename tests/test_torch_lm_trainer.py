"""The port's LM trainer (ddl_tpu_torch/train/lm_trainer.py) against the
JAX package's ``LMTrainer``: the period boundaries for coprime cadences,
the synthetic Markov batches and the corpus windows bit-equal to the JAX
package's for every step, held-out ``val_loss``/``val_ppl`` on the same
parameters, and the CSV rows of ``train()`` at the same steps as the JAX
trainer's.  Snapshots, resume, recovery and profiling are held to the JAX
trainer in ``test_torch_lm_checkpoint.py``."""

import csv
import functools
from pathlib import Path

import jax
import numpy as np
import optax
import pytest
import torch

from ddl_tpu.data.lm_corpus import TokenBatches as JaxTokenBatches
from ddl_tpu.data.lm_corpus import TokenCorpus as JaxTokenCorpus
from ddl_tpu.models.transformer import LMConfig as JaxLMConfig
from ddl_tpu.parallel.sharding import LMMeshSpec as JaxMeshSpec
from ddl_tpu.train.lm_trainer import LMRunConfig as JaxRunConfig
from ddl_tpu.train.lm_trainer import LMTrainer as JaxLMTrainer
from ddl_tpu_torch.data.lm_corpus import TokenBatches, TokenCorpus, encode_text_file
from ddl_tpu_torch.models.convert import lm_params_from_jax
from ddl_tpu_torch.models.transformer import LMConfig
from ddl_tpu_torch.parallel.sharding import LMMeshSpec
from ddl_tpu_torch.train.lm_trainer import LMRunConfig, LMTrainer
from ddl_tpu_torch.train.state import Optimizer

TINY = dict(vocab_size=256, d_model=32, n_layers=1, n_heads=4, head_dim=8, d_ff=64,
            compute_dtype="float32")
# coprime cadences: boundaries 3, 4, 6, 8, 9, 12, 14
RUN = dict(batch=4, seq_len=16, steps=14, log_every=3, eval_every=4, eval_frac=0.25)


def _adamw(params):
    return Optimizer(params, 1e-3, weight_decay=1e-4)


@functools.cache
def _corpus(tmp_root: str) -> str:
    """A byte corpus of 2000 seeded bytes: 124 windows of 16+1 tokens, the
    last 31 held out."""
    path = Path(tmp_root) / "corpus.txt"
    path.write_bytes(np.random.default_rng(7).integers(0, 256, 2000, dtype=np.uint8).tobytes())
    return str(path)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return _corpus(str(tmp_path_factory.mktemp("lm_corpus")))


@functools.cache
def _jax_trainer(corpus_path, **run_kw):
    run = JaxRunConfig(**{**RUN, "corpus": corpus_path, "log_dir": None, **run_kw})
    return JaxLMTrainer(JaxLMConfig(**TINY), JaxMeshSpec(), optax.adamw(1e-3), run,
                        jax.random.key(0))


def _port_trainer(corpus_path, **run_kw):
    run = LMRunConfig(**{**RUN, "corpus": corpus_path, "log_dir": None, **run_kw})
    return LMTrainer(LMConfig(**TINY), LMMeshSpec(), _adamw, run, seed=0, device="cpu")


def test_period_boundaries_match_jax(corpus):
    want = _jax_trainer(corpus)
    got = _port_trainer(corpus)
    assert got._boundaries == want._boundaries == [3, 4, 6, 8, 9, 12, 14]
    assert got.num_periods == want.num_periods
    for p in range(got.num_periods):
        assert got._period_bounds(p) == want._period_bounds(p)
        assert got.log_index(p) == want.log_index(p)
        assert got.log_due(p) == want.log_due(p)


def test_synthetic_batches_are_bit_equal_to_jax():
    want = _jax_trainer(None, eval_every=0)
    got = _port_trainer(None, eval_every=0)
    for step in (0, 1, 7, 13):
        for g, w in zip(got._sample_batch(step), want._sample_batch(step)):
            assert g.dtype == np.int32
            np.testing.assert_array_equal(g, np.asarray(w))


def test_corpus_windows_are_bit_equal_to_jax(corpus):
    want = _jax_trainer(corpus)
    got = _port_trainer(corpus)
    # train steps on both sides of epoch boundaries (93 train windows: 23
    # batches of 4 per epoch), then the held-out batches in order
    for step in (0, 1, 22, 23, 24, 50):
        for g, w in zip(got._sample_batch(step), want._sample_batch(step)):
            np.testing.assert_array_equal(g, np.asarray(w))
    pairs = list(zip(got._eval_batches, want._eval_batches))
    assert len(pairs) == len(want._eval_batches) == 7
    for (gi, gt), (wi, wt) in pairs:
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gt, wt)


def test_token_batches_match_jax_with_shards(corpus):
    npy = encode_text_file(corpus, Path(corpus).with_suffix(".shards.npy"))
    for rank in range(2):
        got = TokenBatches(TokenCorpus(npy, 16), 4, num_shards=2, shard_rank=rank, seed=3)
        want = JaxTokenBatches(JaxTokenCorpus(npy, 16), 4, num_shards=2, shard_rank=rank,
                               seed=3)
        assert len(got) == len(want)
        for step in range(0, 3 * len(got), 5):
            for g, w in zip(got.batch_at(step), want.batch_at(step)):
                np.testing.assert_array_equal(g, w)
        assert got.cursor_state(17) == want.cursor_state(17)


def test_heldout_ppl_matches_jax_on_the_same_params(corpus):
    want_tr = _jax_trainer(corpus)
    got_tr = _port_trainer(corpus)
    got_tr.state.model.load_state_dict(
        lm_params_from_jax(jax.tree_util.tree_map(np.asarray, jax.device_get(
            want_tr.state.params))))
    period = got_tr._boundaries.index(8)
    want = want_tr.evaluate_period(period)
    got = got_tr.evaluate_period(period)
    assert set(got) == {"val_loss", "val_ppl"}
    np.testing.assert_allclose(got["val_loss"], want["val_loss"], rtol=1e-5)
    np.testing.assert_allclose(got["val_ppl"], want["val_ppl"], rtol=1e-5)
    assert got_tr.evaluate_period(got_tr._boundaries.index(9)) is None


def _rows(path: Path) -> list[tuple[int, float]]:
    with open(path, newline="") as f:
        return [(int(r[5]), float(r[6])) for r in csv.reader(f)]


def test_train_writes_the_csv_rows_at_the_jax_steps(corpus, tmp_path):
    run = dict(log_dir=str(tmp_path / "port"), job_id="lm-tiny")
    trainer = _port_trainer(corpus, **run)
    trainer.train()
    assert trainer.state.step == RUN["steps"]
    job = tmp_path / "port" / "by_job_id" / "lm-tiny"
    logged = [3, 6, 9, 12, 14]  # log_every multiples and the last step
    for metric in ("loss", "ce", "moe_aux", "window_time", "steps_per_sec", "tokens_per_sec"):
        assert [e for e, _ in _rows(job / f"{metric}.csv")] == logged, metric
    for metric in ("val_loss", "val_ppl"):
        assert [e for e, _ in _rows(job / f"{metric}.csv")] == [4, 8, 12], metric
    assert [e for e, _ in _rows(job / "epoch_time.csv")] == [0]
    assert all(np.isfinite(v) for _, v in _rows(job / "loss.csv"))
    tps = dict(_rows(job / "tokens_per_sec.csv"))
    wall = dict(_rows(job / "window_time.csv"))
    # the window (4, 6] holds two steps
    np.testing.assert_allclose(tps[6], 2 * RUN["batch"] * RUN["seq_len"] / wall[6], rtol=1e-9)

    jax_dir = tmp_path / "jax"
    jax_run = JaxRunConfig(**{**RUN, "corpus": corpus, "log_dir": str(jax_dir),
                              "job_id": "lm-tiny"})
    JaxLMTrainer(JaxLMConfig(**TINY), JaxMeshSpec(), optax.adamw(1e-3), jax_run,
                 jax.random.key(0)).train()
    jax_job = jax_dir / "by_job_id" / "lm-tiny"
    for metric in ("loss", "window_time", "tokens_per_sec", "val_ppl", "epoch_time"):
        assert ([e for e, _ in _rows(job / f"{metric}.csv")]
                == [e for e, _ in _rows(jax_job / f"{metric}.csv")]), metric


def test_device_none_means_cuda_and_small_vocab_is_refused():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            LMTrainer(LMConfig(**TINY), LMMeshSpec(), _adamw, LMRunConfig(log_dir=None))
    with pytest.raises(ValueError, match="vocab_size"):
        LMTrainer(LMConfig(**{**TINY, "vocab_size": 64}), LMMeshSpec(), _adamw,
                  LMRunConfig(log_dir=None), device="cpu")
