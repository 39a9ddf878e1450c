"""The input pipeline: label files, the synthetic dataset, the datasets,
the loaders and the prefetch onto the card."""
