"""The device memory one call of the program takes at its peak, in GiB:
``torch.cuda.max_memory_allocated`` over the call less what was allocated
when it began (the pool of photos and the outputs kept for the check are
the harness's, not the program's), the largest over the traced run's
untraced calls: its intermediates and its output; of a training step,
the forward's saved activations, the backward's and the gradients (the
layer's scalars and Adam's state are held when it begins). Layer
device."""


def read(rec):
    if not rec.call_peak_bytes:
        return None
    return max(rec.call_peak_bytes) / 2 ** 30
