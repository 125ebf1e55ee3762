"""Image-patch graph (counterpart of
``pygsp_tpu/graphs/nngraphs/imgpatches.py``).

The patches come from ``numpy.lib.stride_tricks.sliding_window_view`` over
the symmetrically padded image, as in the JAX package.
"""

import numpy as np

from pygsp_tpu_torch.graphs.nngraphs.nngraph import NNGraph


class ImgPatches(NNGraph):
    """kNN graph over the image's patches, one vertex per pixel; its
    features are the pixel's patch.

    Examples
    --------
    >>> import numpy as np
    >>> from pygsp_tpu_torch import graphs
    >>> img = np.random.default_rng(0).random((8, 8))
    >>> G = graphs.ImgPatches(img, patch_shape=(3, 3), device='cpu')
    >>> G.N, G.coords.shape
    (64, (64, 9))
    """

    def __init__(self, img, patch_shape=(3, 3), **kwargs):
        self.img = img
        self.patch_shape = patch_shape

        img = np.asarray(img)
        if img.ndim == 2:
            h, w = img.shape
            d = 0
        elif img.ndim == 3:
            h, w, d = img.shape
        else:
            raise ValueError('Image should be a 2D or 3D array.')

        try:
            r, c = patch_shape
        except (TypeError, ValueError):
            r = c = patch_shape[0] if np.iterable(patch_shape) else patch_shape

        pad_width = [(int((r - 0.5) / 2.0), int((r + 0.5) / 2.0)),
                     (int((c - 0.5) / 2.0), int((c + 0.5) / 2.0))]
        if d == 0:
            window_shape = (r, c)
            d = 1
        else:
            pad_width.append((0, 0))
            window_shape = (r, c, d)

        img = np.pad(img, pad_width=pad_width, mode='symmetric')
        patches = np.lib.stride_tricks.sliding_window_view(img, window_shape)
        patches = patches.reshape((h * w, r * c * d))

        super().__init__(patches, **kwargs)

    def _get_extra_repr(self):
        attrs = dict(patch_shape=self.patch_shape)
        attrs.update(super()._get_extra_repr())
        return attrs
