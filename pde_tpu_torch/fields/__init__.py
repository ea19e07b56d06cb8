"""Fields holding ``torch.Tensor`` data on a grid."""

from .base import FieldBase
from .collection import FieldCollection
from .datafield_base import DataFieldBase
from .scalar import ScalarField
