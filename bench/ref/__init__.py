"""The plain reference: each model's whole-graph forward, loss and SGD
step in plain PyTorch over the benchmark's own graph arrays, with no plan,
no kernel and nothing of the program; and each model's count of the work
it needs on the real graph.  One module per model, found by its name."""
