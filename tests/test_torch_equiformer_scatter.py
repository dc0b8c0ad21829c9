"""EquiformerV2's message scatter (`equiformer_v2.message_scatterer`: one
psw_spmm row layout a chunk over the live edges) and the dry-run's form of
it (`dryrun._message_scatterer`: the reference's scatter_sum(msg * mask,
dst, n) a chunk, which picks nothing by value), on the CPU.

The factory is held bitwise to the layout build and scatter that
`forward` did inline before the factory held them (`inline_scatter`); both
forms within 1e-5 of the reference's `scatter_sum` on the masked messages,
their gradients too; the dry-run form runs on meta tensors; and a take-mode
forward under `dryrun.dry_paths` within 1e-5 of the plain one."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.graph.segment_ops import scatter_sum as ref_scatter_sum
from repro_torch.kernels.psw_spmm.ops import prepare_rows, psw_spmm_rows
from repro_torch.launch import dryrun
from repro_torch.models.gnn import equiformer_v2 as eq

TOL = dict(rtol=1e-5, atol=1e-5)
N, E, K, C = 30, 120, 9, 4


def edges(seed):
    """dst (E,) int64, emask (E,) bool with a quarter of the edges masked,
    msgs (E, K, C) float32."""
    rng = np.random.default_rng(seed)
    dst = torch.from_numpy(rng.integers(0, N, E))
    emask = torch.from_numpy(rng.random(E) > 0.25)
    msgs = torch.from_numpy(rng.standard_normal((E, K, C)).astype(np.float32))
    return dst, emask, msgs


def chunks_of(nc):
    Ec = E // nc
    return [slice(c * Ec, (c + 1) * Ec) for c in range(nc)]


def inline_scatter(emask, dst, chunks, msg, c):
    """The scatter as `forward` built it inline: chunk c's live edges by
    `nonzero`, their layout, one psw_spmm_rows."""
    sl = chunks[c]
    live = torch.nonzero(emask[sl]).flatten()
    layout = prepare_rows(live, dst[sl][live], N, device="cpu",
                          n_src=sl.stop - sl.start)
    return psw_spmm_rows(layout, msg.reshape(msg.shape[0], K * C)).reshape(
        N, K, C)


@pytest.mark.parametrize("nc", [1, 4])
def test_the_factory_is_bitwise_the_inline_scatter(nc):
    dst, emask, msgs = edges(nc)
    chunks = chunks_of(nc)
    scatter = eq.message_scatterer(emask, dst, chunks, N, "cpu")
    for c, sl in enumerate(chunks):
        assert torch.equal(scatter(msgs[sl], c),
                           inline_scatter(emask, dst, chunks, msgs[sl], c))


@pytest.mark.parametrize("nc", [1, 4])
def test_both_forms_match_the_reference_scatter_sum(nc):
    """Each chunk's sum, and the messages' gradient of a weighted sum of
    it: the card form (psw_spmm over the live edges) and the dry-run form
    (every edge, its message times its mask) against the reference."""
    dst, emask, msgs = edges(10 + nc)
    chunks = chunks_of(nc)
    w = torch.randn((N, K, C), generator=torch.Generator().manual_seed(nc))
    forms = [eq.message_scatterer(emask, dst, chunks, N, "cpu"),
             dryrun._message_scatterer(emask, dst, chunks, N, "cpu")]
    for c, sl in enumerate(chunks):
        m = msgs[sl].numpy() * emask[sl].numpy()[:, None, None]
        want = np.asarray(ref_scatter_sum(jnp.asarray(m),
                                          jnp.asarray(dst[sl].numpy()), N))
        grads = []
        for scatter in forms:
            x = msgs[sl].clone().requires_grad_()
            out = scatter(x, c)
            np.testing.assert_allclose(out.detach().numpy(), want, **TOL)
            grads.append(torch.autograd.grad((out * w).sum(), x)[0])
        g_want = w[dst[sl]] * emask[sl][:, None, None]
        for g in grads:
            torch.testing.assert_close(g, g_want, **TOL)


def test_the_dry_run_form_runs_on_meta_tensors():
    """No op of the dry-run form needs the values (the factory's `nonzero`
    does): meta inputs give the (n, K, C) meta sum."""
    chunks = chunks_of(4)
    scatter = dryrun._message_scatterer(
        torch.empty(E, dtype=torch.bool, device="meta"),
        torch.empty(E, dtype=torch.int64, device="meta"), chunks, N, "meta")
    out = scatter(torch.empty((E // 4, K, C), device="meta"), 2)
    assert out.device.type == "meta" and out.shape == (N, K, C)


@pytest.mark.parametrize("nc", [1, 4])
def test_a_take_mode_forward_under_dry_paths_matches(nc):
    """`dry_paths` swaps the factory (and wraps `forward`, which passes a
    take-mode batch of plain tensors through): the logits stay within
    1e-5, and the swap is undone after the block."""
    import dataclasses
    from repro_torch import configs
    cfg = dataclasses.replace(configs.get_arch("equiformer-v2").smoke_config,
                              edge_chunks=nc)
    p = eq.init_params(torch.Generator().manual_seed(nc), cfg, "cpu")
    rng = np.random.default_rng(nc)
    dst, emask, _ = edges(20 + nc)
    b = {"species": torch.from_numpy(
             rng.integers(0, cfg.n_species, N).astype(np.int32)),
         "pos": torch.from_numpy(
             rng.standard_normal((N, 3)).astype(np.float32)),
         "src": torch.from_numpy(rng.integers(0, N, E).astype(np.int32)),
         "dst": dst.int(), "edge_mask": emask,
         "node_mask": torch.ones(N, dtype=torch.bool)}
    real = eq.message_scatterer
    with torch.no_grad():
        want = eq.forward(p, b, cfg)
        with dryrun.dry_paths():
            assert eq.message_scatterer is dryrun._message_scatterer
            got = eq.forward(p, b, cfg)
    assert eq.message_scatterer is real
    torch.testing.assert_close(got, want, **TOL)
