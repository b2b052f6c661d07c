"""Model FLOPs of a request's valid work, counted from its shapes by each
model kind (``kinds/<kind>.py``): the acoustic model over its ids and valid
frames, the vocoder over its valid frames.  Padding is not counted.  A
multiply-add is two FLOPs; elementwise work, norms and softmax are left
out (under a part in a thousand of the products)."""

from portbench import kinds


def request_flops(config, n_ids, frames):
    """A request's model FLOPs: encode, decode and vocode of its valid work."""
    acoustic, vocoder = config["acoustic"], config["vocoder"]
    return (kinds.load(acoustic["kind"]).flops(acoustic, n_ids, frames)
            + kinds.load(vocoder["kind"]).flops(vocoder, frames))
