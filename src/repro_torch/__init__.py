"""PyTorch/CUDA port of the GNN-at-the-edge system, held against the JAX
package ``repro`` as its reference.

Slice 1: the data graphs, the partition bridge, the ShardPlan host code,
the GNN models, the batched one-device BSP forward on the hand-written
Hopper BSR SpMM kernel, and the request-serving engine.
Slice 2: dense LM serving (``models``, ``configs``, ``serve``, ``launch``)
with attention on the hand-written Hopper flash-attention kernel.
Later slices: the layout side (``core``, ``runtime``), and GNN training
(``gnn.training``, ``train``, ``launch.train_gnn``) with the SpMM kernel's
backward.
Entry points take ``device=`` and default to the card.
"""
