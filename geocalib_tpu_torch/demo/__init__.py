"""Demos: the overlay CLI and webcam demo, and the gradio web app (optional)."""
