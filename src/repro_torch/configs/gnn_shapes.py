"""The GNN-family input-shape set (a copy of ``repro.configs.gnn_shapes``).

minibatch_lg padded dims follow from batch_nodes=1024 with fanout 15-10:
nodes <= 1024*(1+15+150) = 169,984; edges <= 1024*(15+150) = 168,960.
Feature dims: full_graph_sm = Cora (1433), minibatch_lg = Reddit (602),
ogb_products = 100, molecule = 32 (+ positions for equivariant archs).
"""

GNN_SHAPES = {
    "full_graph_sm": dict(
        kind="gnn_train", n_nodes=2708, n_edges=10556, d_feat=1433,
        n_classes=7, n_graphs=1,
    ),
    "minibatch_lg": dict(
        kind="gnn_train", n_nodes=169_984, n_edges=168_960, d_feat=602,
        n_classes=41, n_graphs=1,
    ),
    "ogb_products": dict(
        kind="gnn_train", n_nodes=2_449_029, n_edges=61_859_140, d_feat=100,
        n_classes=47, n_graphs=1,
    ),
    "molecule": dict(
        kind="gnn_train", n_nodes=30 * 128, n_edges=64 * 128, d_feat=32,
        n_classes=1, n_graphs=128,
    ),
}
