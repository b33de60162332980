"""The loss layer's products: the device time of the program's
``ce.product`` spans (each chunk product of the streamed CE: the forward's
logits, the backward's recomputed logits, ``p @ chunk`` and ``p^T @
user``) a step.  None off the card, where the program has no spans, or
where they did not come four times a chunk of the item table a step."""
from benchmark.harness import spans, work


def read(run):
    try:
        from rec_pangu_tpu_torch.ops.softmax_ce import CHUNK_V
    except ImportError:
        return None
    chunks = -(-work.padded_rows(int(run.config["vocab_size"])) // CHUNK_V)
    return spans.per_call(run, "ce.product", "device_s", per=4 * chunks)
