"""Tree helpers and int8 quantization shared by the models and the trainer."""
