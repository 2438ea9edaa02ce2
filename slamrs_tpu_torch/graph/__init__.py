"""YAML node-graph loading, the fused world (rollouts) and the host
node graph (pub/sub, nodes, ``App``)."""
