"""The simulation engine and its host-side models."""
from isotope_tpu_torch.sim.config import LoadModel, NetworkModel, SimParams
from isotope_tpu_torch.sim.draws import Draws, DrawSpec, TorchDraws
from isotope_tpu_torch.sim.engine import SimResults, Simulator

__all__ = [
    "Draws",
    "DrawSpec",
    "LoadModel",
    "NetworkModel",
    "SimParams",
    "SimResults",
    "Simulator",
    "TorchDraws",
]
