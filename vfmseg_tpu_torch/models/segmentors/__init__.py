"""Segmentors: MsVFM, the plain encoder-decoder and Mask2Former's."""
