from .build import Segmentor, build_segmentor
from .convert import variables_to_state_dict

__all__ = ["Segmentor", "build_segmentor", "variables_to_state_dict"]
