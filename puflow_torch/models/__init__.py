"""Model families: the discrete (Glow-style) interpolation flow."""
