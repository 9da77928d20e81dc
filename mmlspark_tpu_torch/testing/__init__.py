"""Seeded synthetic data (the port's copy of the JAX package's datagen)."""
