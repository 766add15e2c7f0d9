"""The port's entry points, each ``python -m findnpropagate_torch.tools.
<name>``: training and the known / unknown evaluation (train, test), the
self-training and extraction CLIs (train_st, extract_pseudo_labels), the
dataset bootstrap (create_infos), and the
counterparts of the probes under tools/ that reach a Pallas kernel, which
run on the card (``--device cpu`` runs the plain versions on the CPU) and
exit non-zero on a failed or wrong variant."""
