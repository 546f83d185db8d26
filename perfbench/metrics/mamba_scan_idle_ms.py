"""The card waiting on the Mamba scan's host dispatch: the time inside the
``mamba.scan`` spans in which no device event ran, in the traced batches,
over their forwards (``serve.prefill`` and ``serve.decode_step`` spans), in
ms.

Idle time follows the host's speed as much as the layer's: read it only
in interleaved pairs (parent, change, change, parent) within one call on
the card, never across calls."""

from perfbench import spans


def read(run):
    return spans.per(run, lambda t: spans.idle_s(t, "mamba.scan"))
