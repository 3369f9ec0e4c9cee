"""Trading signals of the v7.57 tail: FollowFirst."""
