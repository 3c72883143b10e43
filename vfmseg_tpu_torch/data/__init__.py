"""Host-side data: the synthetic dataset and the prefetching loader."""
