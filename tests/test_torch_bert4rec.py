"""The port's bert4rec (`models/bert4rec.py`, `configs/bert4rec.py`)
against the reference's, on the CPU in float32.

The reference's params are initialised with its own jax key and carried
across with `convert.bert4rec_params_{to,from}_arrays`; item sequences are
seeded numpy ids, left-padded with 0. Representations, scores and the
masked-item loss are held at 1e-5, the tolerance of the reference's
`test_scoring_consistency` and `test_masked_lm_chunked_logsumexp_exact`."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.models import bert4rec as ref_b4r
from repro_torch import configs, convert
from repro_torch.models import bert4rec as b4r

TOL = dict(rtol=1e-5, atol=1e-5)


def port_cfg(ref_cfg):
    kw = {f.name: getattr(ref_cfg, f.name)
          for f in dataclasses.fields(ref_cfg)}
    kw["compute_dtype"] = {jnp.float32: torch.float32}[kw["compute_dtype"]]
    return b4r.Bert4RecConfig(**kw)


def both_params(seed, **kw):
    """The reference's smoke config (or one with `kw` replaced), its
    params and the same params in the port."""
    ref_cfg = dataclasses.replace(ref_get_arch("bert4rec").smoke_config, **kw)
    cfg = port_cfg(ref_cfg)
    p_ref = ref_b4r.init_params(jax.random.PRNGKey(seed), ref_cfg)
    p = convert.bert4rec_params_from_arrays(
        convert.bert4rec_params_to_arrays(p_ref), cfg, "cpu")
    return ref_cfg, cfg, p_ref, p


def histories(cfg, b, seed):
    """(b, seq_len) ids in 1..n_items, left-padded with 0 to lengths in
    1..seq_len (row 0 full, row 1 a single item)."""
    rng = np.random.default_rng(seed)
    seq = rng.integers(1, cfg.n_items + 1, (b, cfg.seq_len))
    lens = rng.integers(1, cfg.seq_len + 1, b)
    lens[:2] = cfg.seq_len, 1
    seq[np.arange(cfg.seq_len)[None, :] < (cfg.seq_len - lens)[:, None]] = 0
    return seq.astype(np.int32)


def test_configs_match_reference():
    ref_spec, spec = ref_get_arch("bert4rec"), configs.get_arch("bert4rec")
    for ref_cfg, cfg in ((ref_spec.config, spec.config),
                         (ref_spec.smoke_config, spec.smoke_config)):
        assert cfg == port_cfg(ref_cfg)
        assert (cfg.vocab, cfg.padded_vocab, cfg.ff) == (
            ref_cfg.vocab, ref_cfg.padded_vocab, ref_cfg.ff)
    assert spec.config.padded_vocab == 1_000_192
    assert {n: dataclasses.asdict(c) for n, c in spec.shapes.items()} == {
        n: dataclasses.asdict(c) for n, c in ref_spec.shapes.items()}
    assert (spec.name, spec.family, spec.source) == (
        ref_spec.name, ref_spec.family, ref_spec.source)
    from repro.configs.bert4rec import RECSYS_SHAPES
    from repro_torch.configs.bert4rec import RECSYS_SHAPES as PORT_SHAPES
    assert PORT_SHAPES == RECSYS_SHAPES


def test_encode_and_scores_match_reference():
    ref_cfg, cfg, p_ref, p = both_params(seed=0)
    seq = histories(cfg, 6, seed=1)
    js, ts = jnp.asarray(seq), torch.from_numpy(seq)
    np.testing.assert_allclose(b4r.encode(p, ts, cfg).numpy(),
                               np.asarray(ref_b4r.encode(p_ref, js, ref_cfg)),
                               **TOL)
    want = np.asarray(ref_b4r.score_all_items(p_ref, js, ref_cfg))
    got = b4r.score_all_items(p, ts, cfg).numpy()
    assert got.shape == (6, cfg.padded_vocab)
    np.testing.assert_allclose(got, want, **TOL)
    # no row is masked: padding, [MASK] and the padded vocab score too
    assert np.isfinite(got).all() and np.isfinite(want).all()
    cand = np.array([3, 17, 42, 0, cfg.n_items + 1, cfg.padded_vocab - 1])
    got_c = b4r.score_candidates(p, ts, torch.from_numpy(cand), cfg).numpy()
    np.testing.assert_allclose(
        got_c, np.asarray(ref_b4r.score_candidates(p_ref, js,
                                                   jnp.asarray(cand),
                                                   ref_cfg)), **TOL)
    np.testing.assert_allclose(got_c, got[:, cand], **TOL)


@pytest.mark.parametrize("vocab_chunk", [7, 16384])
def test_masked_lm_loss_matches_reference(vocab_chunk):
    """The streaming logsumexp over chunks of 7 rows (the last one past
    the table) and over one chunk of 16,384, with an unused label slot;
    the padded rows (ids >= vocab) score -inf."""
    ref_cfg, cfg, p_ref, p = both_params(seed=2)
    rng = np.random.default_rng(3)
    seq = histories(cfg, 4, seed=3)
    seq[:, -1] = rng.integers(1, cfg.n_items + 1, 4)
    mpos = np.stack([rng.choice(cfg.seq_len, 3, replace=False)
                     for _ in range(4)]).astype(np.int32)
    labels = np.take_along_axis(seq, mpos, 1)     # 0 at a padded slot
    labels[1, 2] = 0                               # an unused slot
    np.put_along_axis(seq, mpos, cfg.vocab - 1, 1)  # [MASK]
    batch = {"item_seq": seq, "masked_positions": mpos, "labels": labels}
    want = ref_b4r.masked_lm_loss(p_ref, {k: jnp.asarray(v)
                                          for k, v in batch.items()},
                                  ref_cfg, vocab_chunk=vocab_chunk)
    got = b4r.masked_lm_loss(p, {k: torch.from_numpy(v)
                                 for k, v in batch.items()}, cfg,
                             vocab_chunk=vocab_chunk)
    assert cfg.padded_vocab % 7 != 0
    np.testing.assert_allclose(float(got), float(want), **TOL)
    # the dense softmax cross-entropy over the unpadded vocab
    reps = b4r.encode(p, torch.from_numpy(seq), cfg)
    rows = reps[torch.arange(4)[:, None], torch.from_numpy(mpos).long()]
    logits = rows @ p["item_embed"].T + p["out_bias"]
    logits[..., cfg.vocab:] = -torch.inf
    lab = torch.from_numpy(labels).long()
    ce = torch.logsumexp(logits, -1) - logits.gather(-1, lab[..., None])[..., 0]
    dense = (ce * (lab > 0)).sum() / (lab > 0).sum()
    np.testing.assert_allclose(float(got), float(dense), **TOL)


def test_padding_masked_out():
    """The reference's `test_padding_masked_out`: pad slots are not keys,
    so other items in their place change the outputs and the same padded
    sequence gives the same outputs; and the padding row's embedding
    reaches no real position."""
    ref_cfg, cfg, p_ref, p = both_params(seed=2, n_items=50, embed_dim=16,
                                         n_blocks=1, seq_len=8)
    seq = torch.tensor([[1, 2, 3, 4, 0, 0, 0, 5]])
    seq2 = torch.tensor([[1, 2, 3, 4, 9, 9, 9, 5]])
    r1, r2 = b4r.encode(p, seq, cfg), b4r.encode(p, seq2, cfg)
    assert (r1[0, 0] - r2[0, 0]).abs().max() > 0
    assert torch.equal(r1, b4r.encode(p, seq.clone(), cfg))
    np.testing.assert_allclose(
        r1.numpy(), np.asarray(ref_b4r.encode(p_ref, jnp.asarray(seq.numpy()),
                                              ref_cfg)), **TOL)
    other = {**p, "item_embed": p["item_embed"].clone()}
    other["item_embed"][0] = 7.0
    r3 = b4r.encode(other, seq, cfg)
    real = (seq != 0)[0]
    np.testing.assert_allclose(r3[0, real].numpy(), r1[0, real].numpy(),
                               **TOL)


def test_all_padding_sequence_is_nan_in_both():
    ref_cfg, cfg, p_ref, p = both_params(seed=4)
    seq = histories(cfg, 3, seed=5)
    seq[2] = 0
    got = b4r.score_all_items(p, torch.from_numpy(seq), cfg).numpy()
    want = np.asarray(ref_b4r.score_all_items(p_ref, jnp.asarray(seq),
                                              ref_cfg))
    assert np.isnan(got[2]).all() and np.isnan(want[2]).all()
    np.testing.assert_allclose(got[:2], want[:2], **TOL)


def test_params_round_trip_and_checks():
    ref_cfg, cfg, p_ref, p = both_params(seed=6)
    d = convert.bert4rec_params_to_arrays(p_ref)
    assert list(d) == list(convert.bert4rec_params_to_arrays(p))
    assert "blocks.1.wq" in d and d["item_embed"].shape == (
        cfg.padded_vocab, cfg.embed_dim)
    back = convert.bert4rec_params_to_arrays(p)
    for k in d:
        assert back[k].dtype == d[k].dtype and back[k].tobytes() == \
            d[k].tobytes(), k
    mine = b4r.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    assert {k: v.shape for k, v in convert.bert4rec_params_to_arrays(
        mine).items()} == {k: v.shape for k, v in d.items()}
    bad = dict(d)
    bad["blocks.0.w1"] = bad["blocks.0.w1"][:, :8]
    with pytest.raises(ValueError, match="w1"):
        convert.bert4rec_params_from_arrays(bad, cfg, "cpu")
    bad = dict(d)
    del bad["out_bias"]
    with pytest.raises(ValueError, match="out_bias"):
        convert.bert4rec_params_from_arrays(bad, cfg, "cpu")


def masked_batch(cfg, b, seed):
    """Histories with 3 slots masked a row, one of them unused."""
    rng = np.random.default_rng(seed)
    seq = histories(cfg, b, seed=seed)
    seq[:, -1] = rng.integers(1, cfg.n_items + 1, b)
    mpos = np.stack([rng.choice(cfg.seq_len, 3, replace=False)
                     for _ in range(b)]).astype(np.int32)
    labels = np.take_along_axis(seq, mpos, 1)
    labels[1, 2] = 0
    np.put_along_axis(seq, mpos, cfg.vocab - 1, 1)
    return {"item_seq": seq, "masked_positions": mpos, "labels": labels}


@pytest.mark.parametrize("vocab_chunk", [7, 16384])
def test_masked_lm_gradient_matches_reference(vocab_chunk):
    """Every parameter's gradient of the masked-item loss within 1e-5 of
    `jax.grad` of the reference's (its `jax.checkpoint`ed chunk scan);
    the table's gradient reaches rows through the scores, the gold term
    and the lookups, and is 0 in the padded rows."""
    ref_cfg, cfg, p_ref, p = both_params(seed=8)
    batch = masked_batch(cfg, 4, seed=9)
    g_ref = jax.grad(lambda q: ref_b4r.masked_lm_loss(
        q, {k: jnp.asarray(v) for k, v in batch.items()}, ref_cfg,
        vocab_chunk=vocab_chunk))(p_ref)
    names, leaves = zip(*convert._flatten(p))
    live = [t.requires_grad_() for t in leaves]
    loss = b4r.masked_lm_loss(p, {k: torch.from_numpy(v)
                                     for k, v in batch.items()}, cfg,
                              vocab_chunk=vocab_chunk)
    got = dict(zip(names, (g.numpy() for g in torch.autograd.grad(
        loss, live))))
    want = convert.bert4rec_params_to_arrays(g_ref)
    assert got.keys() == want.keys()
    for key, v in want.items():
        np.testing.assert_allclose(got[key], v, err_msg=key, **TOL)
    assert np.abs(got["item_embed"]).sum() > 0
    assert not got["item_embed"][cfg.vocab:].any()
    assert not got["out_bias"][cfg.vocab:].any()
