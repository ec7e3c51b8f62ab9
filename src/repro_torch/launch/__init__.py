"""Meshes of the port (:mod:`.mesh`)."""
