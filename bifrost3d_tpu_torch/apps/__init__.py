"""Applications: the built-in scenes, the SimpleViewer-style CLI, the
SmallPT app and the EnvironmentConvolution app."""
