"""Segmentors: MsVFM, the plain encoder-decoder, Mask2Former's, HRDA and
the multi-scale encoder-decoder."""
