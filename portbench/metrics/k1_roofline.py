"""K1's share of its roofline: the least time the card could take for the
pair tests greedy NMS needs on the reference's own boxes of a traced batch
(portbench.metrics._pairs), over K1's profiled device time a batch."""
import torch

from portbench.metrics._pairs import k1_bound_s, pairs_needed


def read(run):
    trace, refs = run.trace, run.traced_refs
    if trace is None or not trace.batches or not refs:
        return None
    k1_s = trace.parts_s().get("k1")
    if not k1_s:
        return None
    pairs = boxes = 0
    for ref in refs:
        t = lambda a: torch.as_tensor(a, device=run.check_device)  # noqa: E731
        pairs += pairs_needed(t(ref.sorted_boxes), t(ref.sorted_valid), t(ref.keep),
                              run.head.nms_thresh, run.head.top_k)
        boxes += len(ref.sorted_boxes)
    return 100.0 * k1_bound_s(pairs, boxes) / (k1_s / trace.batches)
