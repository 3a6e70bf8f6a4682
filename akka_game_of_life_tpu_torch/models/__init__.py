"""Model registry of the PyTorch port (counterpart of
``akka_game_of_life_tpu/models``)."""

from akka_game_of_life_tpu_torch.models.registry import CAModel, get_model, list_models

__all__ = ["CAModel", "get_model", "list_models"]
