"""The segmented long-window FFT on one device (counterpart of
`wavespec_tpu/mesh/segmented.py`; the multi-chip forms are not ported)."""
