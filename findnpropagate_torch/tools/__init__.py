"""The port's counterparts of the probes under tools/ that reach a Pallas
kernel: each runs as ``python -m findnpropagate_torch.tools.<name>`` on the
card (``--device cpu`` runs the plain versions on the CPU) and exits
non-zero on a failed or wrong variant."""
