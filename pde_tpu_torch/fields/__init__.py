"""Fields holding ``torch.Tensor`` data on a grid."""

from .base import FieldBase, RankError
from .collection import FieldCollection
from .datafield_base import DataFieldBase
from .scalar import ScalarField
from .tensorial import Tensor2Field
from .vectorial import VectorField
