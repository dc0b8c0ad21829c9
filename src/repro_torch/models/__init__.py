"""Models (port of the reference `repro/models/`): the decoder-only
transformer with its dense and MoE layers, bert4rec, and the GIN, PNA,
MeshGraphNet and EquiformerV2 GNNs, each to serve (forward, prefill and
decode, scoring). Training the transformer and bert4rec (`loss_fn`, the
gradient of `masked_lm_loss`, flash_attention's backward in training) is
ROADMAP slice 8b-ii's."""
from . import bert4rec, gnn, transformer
