"""Monte-Carlo batching."""
