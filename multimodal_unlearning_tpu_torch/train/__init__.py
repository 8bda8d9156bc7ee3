"""The forget step: losses, optimizer and the train step."""
