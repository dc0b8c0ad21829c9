"""The port's bert4rec cells (repro_torch/launch/steps.py) against the
reference's (repro/launch/steps.py) at their batch rules, on the CPU at the
smoke config: the train step at B = 16,384, which both split into 8
microbatches (loss, gradient norm, updated params and AdamW moments within
1e-5), and `serve_bulk` at B = 32,768, two request chunks of 16,384
(values within 1e-5, ids equal but where two scores tie within float
rounding and swap), and a batch of 16,384 + 5 whose last 5 requests the
port serves as a chunk of their own. The reference pads the table to its 8,192-row vocab
chunk, so its train step takes ~45 s here."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.optim import adamw as ref_opt
from repro_torch.optim import adamw_init
from test_torch_steps import check_step, histories, j, plans, rec_params, t


def test_bert4rec_train_step_accumulates_eight_microbatches():
    B = 16384
    rspec, tspec, rplan, tplan = plans("bert4rec", "train_batch", batch=B)
    assert rplan.meta == tplan.meta == {"sequences_per_step": B,
                                        "grad_accum": 8}
    cfg = tspec.config
    p_ref, p = rec_params(3)
    rng = np.random.default_rng(3)
    batch = {"item_seq": histories(cfg, B, 4),
             "masked_positions": rng.integers(0, cfg.seq_len, (B, 40)
                                              ).astype(np.int32),
             "labels": rng.integers(0, cfg.n_items + 1, (B, 40)
                                    ).astype(np.int32)}
    want = jax.jit(rplan.fn)(p_ref, ref_opt.adamw_init(p_ref), j(batch))
    got = tplan.fn(p, adamw_init(p), {k: t(v) for k, v in batch.items()})
    check_step(got, *want, tol=dict(rtol=1e-5, atol=1e-5))


def same_topk(v, i, v_ref, i_ref, tol=1e-5):
    """Values within tol; ids equal but where two scores tie within float
    rounding and swap (the two products round differently): there the
    reference's id sits elsewhere in the port's row with its value, or
    fell off the end beside an equal last value. Returns the swaps."""
    np.testing.assert_allclose(v, v_ref, rtol=tol, atol=tol)
    rows, cols = np.nonzero(i != i_ref)
    for r, c in zip(rows, cols):
        at = np.nonzero(i[r] == i_ref[r, c])[0]
        if at.size:
            assert abs(v[r, at[0]] - v_ref[r, c]) <= tol, (r, c)
        else:
            assert abs(v[r, -1] - v_ref[r, c]) <= tol, (r, c)
    return len(rows)


def test_bert4rec_serve_bulk_in_two_request_chunks():
    B = 32768
    rspec, tspec, rplan, tplan = plans("bert4rec", "serve_bulk", batch=B)
    p_ref, p = rec_params(5)
    seq = histories(tspec.config, B, 6)
    v_ref, i_ref = jax.jit(rplan.fn)(p_ref, jnp.asarray(seq))
    v, i = tplan.fn(p, t(seq))
    assert v.shape == (B, 100) and i.dtype == torch.int32
    n_swapped = same_topk(v.numpy(), i.numpy(), np.asarray(v_ref),
                          np.asarray(i_ref))
    assert n_swapped < B * 100 // 1000


def test_bert4rec_serve_bulk_serves_a_short_last_chunk():
    """B = 16,384 + 5: the reference's reshape refuses a batch that is no
    multiple of its request chunk; the port serves the last 5 requests as
    a chunk of their own, held against the reference's step at B = 5."""
    B = 16384 + 5
    rspec, tspec, rplan, tplan = plans("bert4rec", "serve_bulk", batch=B)
    p_ref, p = rec_params(7)
    seq = histories(tspec.config, B, 8)
    v, i = tplan.fn(p, t(seq))
    assert v.shape == i.shape == (B, 100)
    v_ref, i_ref = jax.jit(rplan.fn)(p_ref, jnp.asarray(seq[-5:]))
    same_topk(v[-5:].numpy(), i[-5:].numpy(), np.asarray(v_ref),
              np.asarray(i_ref))
