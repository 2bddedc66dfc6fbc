"""Demos: drive a trained Anymal from the keyboard (`interactive`) or a
scripted command sequence over rough terrain (`anymal_terrain`)."""
