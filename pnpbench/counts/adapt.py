"""The online adaptation's operations: each Adam step evaluates the
denoiser's forward once and its backward, which costs two forwards (the
gradients with respect to the activations and to the weights), so three
forwards a step."""

FORWARDS_PER_STEP = 3


def flops(forward_flops: int, steps: int) -> int:
    return FORWARDS_PER_STEP * forward_flops * steps
