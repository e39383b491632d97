"""Stage 6: rendering at the solved poses, hand-masked metrics, LPIPS."""
