"""Path integration, the render stream and JPEG/GIF output."""
