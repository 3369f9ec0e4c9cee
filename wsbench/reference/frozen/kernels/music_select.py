"""The MUSIC candidate selection of the frozen reference: the plain
version, on any device."""

from wsbench.reference.frozen.analyze.music import select_candidates_plain as select_candidates


