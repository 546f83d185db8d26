"""MLA decode's expansion of the latent cache: the device time of the
kernels launched inside the ``mla.expand`` spans (the ``wukv`` product,
the split and the key ``cat``) in the traced batches, over their decode
steps (``serve.decode_step`` spans), in ms."""

from perfbench import spans


def read(run):
    return spans.per(run, lambda t: spans.device_s(t, "mla.expand"),
                     ("serve.decode_step",))
