"""Algorithm core: the reference's per-base dict loops re-expressed over
columnar numpy arrays (SURVEY §3.5 hot spots), with the reference's exact
greedy semantics preserved where output parity depends on them (§5.9).
"""
