"""Partial-order-alignment consensus engine (replaces `abpoa -M 5 -r 0
[-S]`, SDC.py:915-919).

Two engines: the STAR path (poa/star.py), backbone alignment + column
votes, whose DP fills ride the aligner's native solver, and the general
graph engine (poa/graph.py, the default): sequence-to-DAG affine DP over
topologically ordered node arrays with a query band, incremental graph
growth per read, and heaviest-bundle consensus extraction. The graph DP
runs in the native C++ engine or, batched over isoforms, on the device
(poa/kernels.py).
"""

from mandalorion_tpu_torch.poa.consensus import determine_consensus  # noqa: F401
from mandalorion_tpu_torch.poa.graph import PoaGraph  # noqa: F401

# poa_consensus (the pure-Python graph oracle) is deliberately NOT
# re-exported: the production consensus entry point with the length
# policy (PoaConfig.max_graph_len / overlength_fallback) is
# determine_consensus; tests import the oracle from poa.graph directly.
