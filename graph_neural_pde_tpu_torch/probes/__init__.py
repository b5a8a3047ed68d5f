"""Measurement probes on the card (``python -m
graph_neural_pde_tpu_torch.probes.gather``)."""
