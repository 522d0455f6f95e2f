"""Data parallelism: one process a device, the batch split on axis 0."""
