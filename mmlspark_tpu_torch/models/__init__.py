"""Model zoo, weight carry-over and the TorchModel inference stage."""
