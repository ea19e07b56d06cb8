"""Visualization of fields and simulation results."""

from .movies import Movie, movie, movie_multiple, movie_scalar
from .plotting import (
    ScalarFieldPlot,
    extract_field,
    plot_interactive,
    plot_kymograph,
    plot_kymographs,
    plot_magnitudes,
)
