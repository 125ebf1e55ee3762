"""Grid and image-patch graphs aggregated (counterpart of
``pygsp_tpu/graphs/nngraphs/grid2dimgpatches.py``)."""

from pygsp_tpu_torch.graphs.graph import Graph
from pygsp_tpu_torch.graphs.grid2d import Grid2d
from pygsp_tpu_torch.graphs.nngraphs.imgpatches import ImgPatches


class Grid2dImgPatches(Graph):
    """The pixel grid's graph and the patch graph, aggregated (by default
    summed). ``device`` and ``dtype`` apply to all three graphs; the other
    keywords go to :class:`ImgPatches`.

    Examples
    --------
    >>> import numpy as np
    >>> from pygsp_tpu_torch import graphs
    >>> img = np.random.default_rng(0).random((8, 8))
    >>> G = graphs.Grid2dImgPatches(img, device='cpu')
    >>> G.N, G.coords.shape           # the grid's layout
    (64, (64, 2))
    """

    def __init__(self, img, aggregate=lambda Wp, Wg: Wp + Wg, **kwargs):
        on = {key: kwargs[key] for key in ('device', 'dtype') if key in kwargs}
        self.Gg = Grid2d(img.shape[0], img.shape[1], **on)
        self.Gp = ImgPatches(img, **kwargs)
        W = aggregate(self.Gp.W, self.Gg.W)
        super().__init__(W, coords=self.Gg.coords, plotting=self.Gg.plotting,
                         **on)

    def _get_extra_repr(self):
        attrs = self.Gg._get_extra_repr()
        attrs.update(self.Gp._get_extra_repr())
        return attrs
