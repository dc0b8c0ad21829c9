"""Synthetic data streams: host copies of the reference `repro/data/`
(numpy only), the same streams for a seed."""
from .linkbench import LinkBenchConfig, LinkBenchWorkload, REQUEST_MIX
from .pipeline import GraphStream, TokenStream, TokenStreamConfig
