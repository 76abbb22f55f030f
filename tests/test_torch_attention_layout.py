"""``ops.attention.pad_rows``: the layouts the attention kernel does not
read (rows of H*hd channels off the 16-byte unit, heads apart where hd is
off the 8-channel unit, hd strided) copied into rows padded to a multiple of
8 channels, heads side by side; a layout it reads passed as it is. The copy
holds the same values and the strides the kernel takes
(``layout_taken``). The kernel on such copies is held against its plain
version on the card (``tests/test_torch_cuda.py``)."""

import pytest
import torch

from lm2a_tpu_torch.ops.attention import layout_taken, pad_rows


def _projection_view(b, h, t, hd, pad=0, seed=0):
    """(B, H, T, hd) view of a channels-last (B, T, H*hd + pad) tensor."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((b, t, h * hd + pad), generator=g).to(torch.bfloat16)
    return x[:, :, :h * hd].view(b, t, h, hd).transpose(1, 2)


@pytest.mark.parametrize("h,hd", [(3, 5), (5, 3), (3, 2), (1, 7), (3, 12), (2, 4)])
@pytest.mark.parametrize("t", [1, 37])
def test_pad_rows_of_projections(h, hd, t):
    x = _projection_view(2, h, t, hd, seed=h * hd + t)
    y = pad_rows(x)
    assert layout_taken(y) and y.shape == x.shape and torch.equal(y, x)
    if layout_taken(x):  # rows of H*hd a multiple of 8 channels: read as they lie
        assert y is x
    else:
        c = y.stride()[2]
        assert c % 8 == 0 and c >= h * hd and y.stride()[1] == hd


def test_pad_rows_of_heads_apart_and_strided_hd():
    x = torch.randn((2, 4, 16, 2)).to(torch.bfloat16)  # contiguous (B, H, T, hd): heads apart
    assert not layout_taken(x)
    y = pad_rows(x)
    assert layout_taken(y) and torch.equal(y, x) and y.stride()[1] == 2
    w = torch.randn((1, 2, 16, 64)).to(torch.bfloat16)[..., ::2]  # hd at stride 2
    assert not layout_taken(w)
    z = pad_rows(w)
    assert layout_taken(z) and torch.equal(z, w) and z.stride()[3] == 1
