"""The tracker of the frozen reference: the plain version, on any device."""

from wsbench.reference.frozen.analyze.trackers import track_frames_plain as track_frames_kernel


