"""The v7.57 tail of the frozen reference: the plain version, on any device."""

from wsbench.reference.frozen.pipeline.tail import v757_tail_plain as v757_tail


