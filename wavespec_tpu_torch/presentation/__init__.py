"""Presentation layer: the CSV export (the palettes and cycle views of
`wavespec_tpu/presentation` are not ported yet)."""

from wavespec_tpu_torch.presentation.export import CsvExporter

__all__ = ["CsvExporter"]
