"""Hash encoders of the port and the Flax->torch weight converter."""
