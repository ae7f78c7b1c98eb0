"""Port of ``microtipi_tpu.models``: every PSF family, each as a frozen
config of numbers (``XConfig``, the JAX package's class name) and the
``nn.Module`` that holds its static buffers on a device (``XModel``).
:func:`model_for` builds the model a config describes."""
import torch

from microtipi_tpu_torch.models.confocal import ConfocalConfig, ConfocalModel, TwoPhotonConfig, TwoPhotonModel
from microtipi_tpu_torch.models.fourpi import FourPiConfig, FourPiModel, FourPiParams
from microtipi_tpu_torch.models.gibson_lanni import GibsonLanniConfig, GibsonLanniModel, GibsonLanniParams
from microtipi_tpu_torch.models.ism import ISMConfig, ISMModel, hex_offsets
from microtipi_tpu_torch.models.lightsheet import (
    LightSheetConfig,
    LightSheetModel,
    LightSheetParams,
    StructuredSheetConfig,
    StructuredSheetModel,
)
from microtipi_tpu_torch.models.microscope import (
    CAVITY,
    DEFOCUS,
    DEPTH,
    FAMILY_NAMES,
    MODULUS,
    PARAMETER_FLAGS,
    PHASE,
    SHEET,
    STED,
)
from microtipi_tpu_torch.models.sted import STEDConfig, STEDModel, STEDParams
from microtipi_tpu_torch.models.vectorial import VectorialConfig, VectorialModel
from microtipi_tpu_torch.models.widefield import WideFieldConfig, WideFieldModel, WideFieldParams

__all__ = [
    "WideFieldConfig", "WideFieldModel", "WideFieldParams",
    "GibsonLanniConfig", "GibsonLanniModel", "GibsonLanniParams",
    "ISMConfig", "ISMModel", "hex_offsets", "StructuredSheetConfig", "StructuredSheetModel",
    "FourPiConfig", "FourPiModel", "FourPiParams",
    "ConfocalConfig", "ConfocalModel", "TwoPhotonConfig", "TwoPhotonModel", "VectorialConfig", "VectorialModel",
    "LightSheetConfig", "LightSheetModel", "LightSheetParams", "STEDConfig", "STEDModel", "STEDParams",
    "DEFOCUS", "PHASE", "MODULUS", "DEPTH", "SHEET", "STED", "CAVITY", "PARAMETER_FLAGS", "FAMILY_NAMES",
    "MODELS", "model_for",
]

#: Each config class and the model class it describes.
MODELS = {
    WideFieldConfig: WideFieldModel, GibsonLanniConfig: GibsonLanniModel, ConfocalConfig: ConfocalModel,
    TwoPhotonConfig: TwoPhotonModel, VectorialConfig: VectorialModel, LightSheetConfig: LightSheetModel,
    StructuredSheetConfig: StructuredSheetModel, ISMConfig: ISMModel, FourPiConfig: FourPiModel,
    STEDConfig: STEDModel,
}


def model_for(config, device: torch.device | str = "cuda") -> WideFieldModel:
    """The model of ``config``'s family on ``device`` (the card by default)."""
    return MODELS[type(config)](config, device)
