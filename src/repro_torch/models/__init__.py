"""Models (port of the reference `repro/models/`): the decoder-only
transformer with its dense and MoE layers, bert4rec, and the GIN, PNA,
MeshGraphNet and EquiformerV2 GNNs, each to serve (forward, prefill and
decode, scoring) and to train (the transformer's `loss_fn`, bert4rec's
`masked_lm_loss`, every GNN's forward under autograd)."""
from . import bert4rec, gnn, transformer
