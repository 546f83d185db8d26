"""``decode_step_ms`` in the cells whose rate is ``output_tokens_per_s.decode``:
the same reading, under a name that moves that rate."""

from perfbench import spec


def read(run):
    return spec.reader("decode_step_ms")(run)
