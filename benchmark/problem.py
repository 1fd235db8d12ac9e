"""The yardstick's arithmetic: the card's published peaks, the render
kernels' operations and bytes, and the reconstruction network's
operations, all counted from the problem (faces, pixels, layer shapes),
never from how the program packs, sorts, culls or compacts them."""

from __future__ import annotations

# NVIDIA H100 SXM data sheet: float32 outside the tensor cores, HBM3
FP32_FLOPS = 67e12
HBM_BYTES = 3.35e12

# float operations a gated (pixel, face) pair costs the render kernels,
# counted in the kernels' sources for alpha-only rendering with the
# probabilistic t-conorm: the fold (2) and its aggregate-inverse rule (4)
# included
FWD_FLOPS_PER_PAIR = 73
BWD_FLOPS_PER_PAIR = 110


def bound_s(flops, nbytes):
    """The least time the card could take: the larger of the operations
    over the float32 peak and the bytes over HBM bandwidth."""
    return max(flops / FP32_FLOPS, nbytes / HBM_BYTES)


def render_work(pairs, batch, faces, image_size):
    """{'fwd_flops', 'fwd_bytes', 'bwd_flops', 'bwd_bytes'} of one alpha
    render and its gradient: each input read once, each output written
    once (the faces' vertices, the [16] parameter vector, the alpha image,
    its gradient, the vertices' gradient; float32)."""
    fv = batch * faces * 9 * 4
    image = batch * image_size * image_size * 4
    return dict(fwd_flops=FWD_FLOPS_PER_PAIR * pairs,
                fwd_bytes=fv + 64 + image,
                bwd_flops=BWD_FLOPS_PER_PAIR * pairs,
                bwd_bytes=fv + 64 + 2 * image + fv)


def conv_out(size, kernel=5, stride=2, pad=2):
    return (size + 2 * pad - kernel) // stride + 1


def network_flops(images, samples, image_size, widths, dims, decoder,
                  vertices):
    """Float operations of the reconstruction network's forward and
    backward: the encoder's 5x5 stride-2 convolutions over ``images``
    pictures of ``widths`` channels and its linear layers ``dims``, the
    decoder's linear layers (``decoder``: its widths, then 3 and 3 x
    vertices outputs) over ``samples`` feature vectors.  The backward is
    twice the forward (the weights' and the inputs' gradients), except
    for the first convolution, whose input (the images) takes none."""
    total, size = 0.0, image_size
    for i, (cin, cout) in enumerate(zip(widths[:-1], widths[1:])):
        size = conv_out(size)
        fwd = 2.0 * images * size * size * cout * cin * 25
        total += fwd * (2 if i == 0 else 3)
    flat = widths[-1] * size * size
    for din, dout in zip((flat,) + tuple(dims[:-1]), dims):
        total += 3 * 2.0 * images * din * dout
    d_in = dims[-1]
    w1, w2 = decoder
    for din, dout in ((d_in, w1), (w1, w2), (w2, 3), (w2, 3 * vertices)):
        total += 3 * 2.0 * samples * din * dout
    return total
