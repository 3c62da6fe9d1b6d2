"""Seconds of 16 kHz audio trained per wall second: every step of the window
times the global batch's audio (every card's), over the whole window (host
clock, the device synced at both ends; rank 0's under a mesh). Also the
reader of `audio_s_per_s.t1024` and `.dp`: the same rate in
cells whose host-paced steps spread wider, under names of their own so
that their bounds stay apart."""


def read(rec):
    return rec.steps * rec.audio_per_step / rec.window_s
