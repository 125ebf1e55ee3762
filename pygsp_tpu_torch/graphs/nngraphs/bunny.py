"""Stanford bunny (counterpart of ``pygsp_tpu/graphs/nngraphs/bunny.py``)."""

from pygsp_tpu_torch import utils
from pygsp_tpu_torch.graphs.nngraphs.nngraph import NNGraph


class Bunny(NNGraph):
    """The Stanford bunny's 2503 points (bundled), radius graph.

    Examples
    --------
    >>> from pygsp_tpu_torch import graphs
    >>> G = graphs.Bunny(device='cpu')
    >>> G.N, G.Ne, G.coords.shape
    (2503, 78292, (2503, 3))
    """

    def __init__(self, **kwargs):
        data = utils.loadmat('bunny')
        plotting = {'vertex_size': 10, 'elevation': -90, 'azimuth': 90,
                    'distance': 8}
        super().__init__(Xin=data['bunny'], epsilon=0.02, NNtype='radius',
                         center=False, rescale=False, plotting=plotting,
                         **kwargs)
