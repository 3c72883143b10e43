"""Host-side data: the synthetic dataset, the prefetching loader, and the
eval side's transforms and dataset readers."""
