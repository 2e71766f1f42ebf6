"""Applications: the built-in scenes and the SimpleViewer-style CLI."""
