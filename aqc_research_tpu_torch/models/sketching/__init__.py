"""AQC sketching model: full/sketched compiling of target unitaries."""

from .aqc_coord_descent import aqc_coordinate_descent
from .aqc_sketching import aqc_sketching
from .sk_core import (
    AlternatingSketchingVectors,
    EigenSketchingVectors,
    FullRangeSketchingVectors,
    RandomSketchingVectors,
    SketchingObjectiveEx,
    SketchingVectorsBase,
    skvecs_generator,
)
from .sk_utils import create_ansatz, create_target_matrix, fidelity
