"""Models: segmentors, heads and backbones of every config under configs/."""
